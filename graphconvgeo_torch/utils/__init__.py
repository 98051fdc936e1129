"""Metrics logging, device selection and the CUDA kernel build."""
