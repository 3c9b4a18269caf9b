"""Document indexing: the reconciler, the schedulers and the index task."""
