"""Config, IQ, filter design and JSON output (copies of the JAX package's
``utils``), and conversion helpers between the port and the JAX package."""
