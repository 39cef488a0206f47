"""Adapters that drive each entry of the port a traffic mix names, one module an entry."""
