"""Index builders beside the vector index (port of the JAX package's index/)."""
