"""Synthetic captures for the port's tests and its GPU smoke run."""
