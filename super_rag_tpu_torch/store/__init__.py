"""Storage of the PyTorch port: the object store for documents and index
snapshots, and the sqlite metadata store."""
