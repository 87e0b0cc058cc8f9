"""Receive-chain stages on torch tensors, with the numpy plan builders."""
