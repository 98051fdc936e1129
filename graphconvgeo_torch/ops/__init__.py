"""Sparse products, dropout and the streamed loss head; ``spmm_bsr`` holds the CUDA kernel wrapper."""
