"""Conversion helpers between the port and the JAX package."""
