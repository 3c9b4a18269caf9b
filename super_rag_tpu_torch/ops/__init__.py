"""Search ops: dense top-k (CUDA kernel + plain version), BM25, fusion."""
