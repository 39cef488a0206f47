"""Seeded NumPy generators of each family's inputs, one module a family."""
