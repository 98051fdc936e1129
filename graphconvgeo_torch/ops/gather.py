"""Row gather ``out[j] = h[idx[j]]``: the hand-written CUDA kernel and its
plain twin.

Port of ``graphconvgeo_tpu/ops/gather_pallas.py :: gather_rows_pallas``, a
DMA-ring row gather that the JAX package keeps as a measured negative
result with no production caller (its SpMM paths gather with XLA). It is
the row gather the ``ell`` backend's ``_ell_matvec`` does.

- :func:`gather_rows_plain` — ``index_select``. The CPU path and the
  card-side check (bit-equal: both copy bytes).
- :func:`gather_rows` — the wrapper: a CPU tensor takes the plain version; a
  CUDA tensor launches ``csrc/gather.cu`` and counts the launch, or raises.

The kernel copies 16-byte vectors, so it takes any row of a whole number of
them: float32 rows of a multiple of 4 values, bfloat16 rows of a multiple of
8 — every shape the JAX kernel takes (``F·itemsize % 512 == 0``) and more.
The JAX kernel's ``block_rows`` only pads on the TPU and is dropped. Valid
indices are the caller's contract, as in JAX: nothing checks them.
"""

from __future__ import annotations

import ctypes

import torch

from graphconvgeo_torch.utils import cuda_build

KERNEL = "gather_rows"
_DTYPES = (torch.float32, torch.bfloat16)


def gather_rows_plain(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[M, F] = h[idx], in plain PyTorch."""
    return h.index_select(0, idx)


def _kernel_fn():
    fn = cuda_build.load("gather").gather_rows_16b
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[j] = h[idx[j]] for h [N, F] float32 or bfloat16 and idx [M]
    int32. CPU tensors take :func:`gather_rows_plain`; CUDA tensors launch
    the kernel on the current stream and count the launch."""
    if h.device.type == "cpu":
        return gather_rows_plain(h, idx)
    if h.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, got {h.device}")
    if h.dtype not in _DTYPES:
        raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"idx must be a 1-D int32 tensor, got {idx.dtype} of {idx.dim()} dims")
    if idx.device != h.device:
        raise ValueError(f"idx is on {idx.device}, h on {h.device}")
    if h.dim() != 2 or not h.is_contiguous() or not idx.is_contiguous():
        raise ValueError("h must be a contiguous [N, F] tensor and idx contiguous")
    row_bytes = h.shape[1] * h.element_size()
    if row_bytes % 16 or h.data_ptr() % 16:
        raise ValueError(f"gather_rows copies 16-byte vectors: a row of {row_bytes} bytes does not split")
    out = torch.empty((idx.shape[0], h.shape[1]), dtype=h.dtype, device=h.device)
    if idx.shape[0] == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(h.device):
        err = fn(
            h.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], row_bytes,
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed with CUDA error {err}")
    cuda_build.launch_counts[KERNEL] += 1
    return out
