"""Services of the port (the JAX package's service/ layer)."""
