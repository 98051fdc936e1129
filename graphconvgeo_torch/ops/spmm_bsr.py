"""Flat-tile block-sparse SpMM: the hand-written CUDA kernel and its plain twin.

Port of ``graphconvgeo_tpu/ops/spmm_pallas.py :: _bsr_flat_matmul`` and its
custom-VJP wrapper ``spmm_bsr_flat``. For each tile t of a :class:`BsrFlat`
(sorted by row block, then column block) the product adds
``tiles[t] @ h[colblk[t]·B : +B]`` into output row block ``rowblk[t]``.

- :func:`bsr_flat_matmul_plain` — the same function in plain PyTorch (one
  batched matmul over the gathered column blocks, then ``index_add_`` into
  the row blocks of a zero output). The CPU path and the card-side check.
- :func:`bsr_flat_matmul` — the wrapper: a CPU tensor takes the plain
  version; a CUDA tensor launches ``csrc/bsr_flat.cu`` (true float32 FFMA)
  or raises. There is no fallback from one to the other.
- :func:`spmm_bsr_flat` — pads ``h`` to the tile grid and runs the product
  through an autograd Function whose backward is the same kernel on the
  transpose operand's tiles (``Âᵀ·G``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from graphconvgeo_torch.sparse.formats import BsrFlat, _round_up
from graphconvgeo_torch.utils import cuda_build

KERNEL = "bsr_flat_matmul"
# the kernel's CTA covers 64 output columns; spmm_bsr_flat pads F to 128
F_ALIGN = 64


def bsr_flat_matmul_plain(mat: BsrFlat, h: torch.Tensor) -> torch.Tensor:
    """[n_row_blocks·B, F] = flat-tile BSR(mat) @ h, in plain PyTorch.
    ``h`` is [n_cols_padded, F]."""
    b, f = mat.block, h.shape[1]
    prod = torch.bmm(mat.tiles, h.reshape(-1, b, f)[mat.colblk.long()])
    out = torch.zeros(mat.n_row_blocks, b, f, dtype=prod.dtype, device=h.device)
    out.index_add_(0, mat.rowblk.long(), prod)
    return out.view(-1, f)


def _kernel_fn():
    fn = cuda_build.load("bsr_flat").bsr_flat_matmul_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(mat: BsrFlat, h: torch.Tensor) -> None:
    b = mat.block
    if b not in (128, 256):
        raise ValueError(f"bsr_flat kernel takes block 128 or 256, got {b}")
    for name, t, dtype in (
        ("tiles", mat.tiles, torch.float32),
        ("colblk", mat.colblk, torch.int32),
        ("row_ptr", mat.row_ptr, torch.int32),
        ("h", h, torch.float32),
    ):
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mat.tiles.dim() != 3 or tuple(mat.tiles.shape[1:]) != (b, b):
        raise ValueError(f"tiles must be [T, {b}, {b}], got {tuple(mat.tiles.shape)}")
    if tuple(mat.row_ptr.shape) != (mat.n_row_blocks + 1,):
        raise ValueError("row_ptr must have n_row_blocks + 1 entries")
    if h.dim() != 2 or h.shape[0] != mat.n_cols_padded or h.shape[1] % F_ALIGN:
        raise ValueError(
            f"h must be [{mat.n_cols_padded}, multiple of {F_ALIGN}], got {tuple(h.shape)}"
        )
    if h.data_ptr() % 16 or mat.tiles.data_ptr() % 16:
        raise ValueError("h and tiles must be 16-byte aligned")


def bsr_flat_matmul(mat: BsrFlat, h: torch.Tensor) -> torch.Tensor:
    """[n_row_blocks·B, F] float32 = flat-tile BSR(mat) @ h.

    CPU tensors take :func:`bsr_flat_matmul_plain`; CUDA tensors launch the
    kernel on the current stream and count the launch."""
    if h.device.type == "cpu":
        return bsr_flat_matmul_plain(mat, h)
    if h.device.type != "cuda":
        raise ValueError(f"bsr_flat_matmul runs on cpu or cuda, got {h.device}")
    _check_cuda_operands(mat, h)
    fn = _kernel_fn()
    out = torch.empty((mat.n_rows_padded, h.shape[1]), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        err = fn(
            mat.tiles.data_ptr(),
            mat.colblk.data_ptr(),
            mat.row_ptr.data_ptr(),
            h.data_ptr(),
            out.data_ptr(),
            mat.n_row_blocks,
            mat.block,
            h.shape[1],
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bsr_flat kernel launch failed with CUDA error {err}")
    cuda_build.launch_counts[KERNEL] += 1
    return out


class _FlatCore(torch.autograd.Function):
    """out = BSR(mat) @ h_p; dh_p = BSR(mat_t) @ g — the backward is the
    same kernel on the transpose operand (the JAX package's ``_flat_bwd``)."""

    @staticmethod
    def forward(ctx, h_p, mat, mat_t):
        ctx.mat_t = mat_t
        return bsr_flat_matmul(mat, h_p)

    @staticmethod
    def backward(ctx, g):
        return bsr_flat_matmul(ctx.mat_t, g.contiguous()), None, None


def spmm_bsr_flat(mat: BsrFlat, mat_t: BsrFlat, h: torch.Tensor) -> torch.Tensor:
    """Flat-tile block-sparse SpMM, differentiable in ``h`` (``mat_t``
    drives the backward ``Âᵀ·G``; symmetric operators pass the same operand
    twice). Returns ``mat.n_rows`` rows of ``h``'s width."""
    f = h.shape[1]
    f_pad = _round_up(f, 128)
    rows = mat.n_cols_padded
    m = min(h.shape[0], rows)
    h_p = h if tuple(h.shape) == (rows, f_pad) else F.pad(h[:m], (0, f_pad - f, 0, rows - m))
    out = _FlatCore.apply(h_p.contiguous(), mat, mat_t)
    return out[: mat.n_rows, :f]
