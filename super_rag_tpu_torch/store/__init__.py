"""Storage backends of the PyTorch port (the object store for documents
and index snapshots)."""
