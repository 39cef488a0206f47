"""Adapters that build each family's problem in the port, one module a family."""
