"""Block-sparse SpMM: the hand-written CUDA kernels and their plain twins.

Two products over densified ``B × B`` tiles, one CUDA body
(``csrc/bsr_flat.cu``) with two index maps:

- Port of ``graphconvgeo_tpu/ops/spmm_pallas.py :: _bsr_flat_matmul`` and
  its custom-VJP wrapper ``spmm_bsr_flat`` (the ``hybrid`` backend's dense
  part). For each tile t of a :class:`BsrFlat` (sorted by row block, then
  column block) the product adds ``tiles[t] @ h[colblk[t]·B : +B]`` into
  output row block ``rowblk[t]``.
- Port of ``graphconvgeo_tpu/ops/spmm_pallas.py :: _bsr_matmul`` and its
  custom-VJP wrapper ``spmm_bsr`` (the ``bsr`` backend). For each row block
  r of a :class:`BsrMatrix` and each of its ``k_max`` slots k the product
  adds ``tiles[tile_idx[r, k]] @ h[tile_col[r, k]·B : +B]``; padding slots
  point at the all-zero tile 0.

For each: ``*_plain`` is the same function in plain PyTorch (the CPU path
and the card-side check); the wrapper takes the plain version for a CPU
tensor and, for a CUDA tensor, launches the kernel (true float32 FFMA) and
counts the launch, or raises — there is no fallback from one to the other;
``spmm_*`` pads ``h`` to the tile grid and runs the product through an
autograd Function whose backward is the same kernel on the transpose
operand's tiles (``Âᵀ·G``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from graphconvgeo_torch.sparse.formats import BsrFlat, BsrMatrix, _round_up
from graphconvgeo_torch.utils import cuda_build

KERNEL = "bsr_flat_matmul"
KERNEL_PADDED = "bsr_matmul"
# the kernel's CTA covers 64 output columns; spmm_bsr* pad F to 128
F_ALIGN = 64


def bsr_flat_matmul_plain(mat: BsrFlat, h: torch.Tensor) -> torch.Tensor:
    """[n_row_blocks·B, F] = flat-tile BSR(mat) @ h, in plain PyTorch.
    ``h`` is [n_cols_padded, F]."""
    b, f = mat.block, h.shape[1]
    prod = torch.bmm(mat.tiles, h.reshape(-1, b, f)[mat.colblk.long()])
    out = torch.zeros(mat.n_row_blocks, b, f, dtype=prod.dtype, device=h.device)
    out.index_add_(0, mat.rowblk.long(), prod)
    return out.view(-1, f)


def bsr_matmul_plain(mat: BsrMatrix, h: torch.Tensor) -> torch.Tensor:
    """[n_row_blocks·B, F] = padded-list BSR(mat) @ h, in plain PyTorch: one
    batched product over the row blocks per slot, summed in slot order.
    ``h`` is [n_cols_padded, F]."""
    b, f = mat.block, h.shape[1]
    hb = h.reshape(-1, b, f)
    out = None
    for k in range(mat.k_max):
        part = torch.bmm(mat.tiles[mat.tile_idx[:, k].long()], hb[mat.tile_col[:, k].long()])
        out = part if out is None else out + part
    return out.reshape(-1, f)


def _kernel_fn(name: str, n_ints: int):
    fn = getattr(cuda_build.load("bsr_flat"), name)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(mat, index_arrays, h: torch.Tensor) -> None:
    b = mat.block
    if b not in (128, 256):
        raise ValueError(f"bsr kernels take block 128 or 256, got {b}")
    for name, t, dtype in (
        ("tiles", mat.tiles, torch.float32),
        *((n, a, torch.int32) for n, a in index_arrays),
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
    if h.dim() != 2 or h.shape[0] != mat.n_cols_padded or h.shape[1] % F_ALIGN:
        raise ValueError(
            f"h must be [{mat.n_cols_padded}, multiple of {F_ALIGN}], got {tuple(h.shape)}"
        )
    if h.data_ptr() % 16 or mat.tiles.data_ptr() % 16:
        raise ValueError("h and tiles must be 16-byte aligned")


def _launch(kernel: str, name: str, mat, index_arrays, ints, h: torch.Tensor) -> torch.Tensor:
    if h.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cpu or cuda, got {h.device}")
    _check_cuda_operands(mat, index_arrays, h)
    fn = _kernel_fn(name, len(ints) + 2)
    out = torch.empty((mat.n_rows_padded, h.shape[1]), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        err = fn(
            mat.tiles.data_ptr(),
            *(a.data_ptr() for _, a in index_arrays),
            h.data_ptr(),
            out.data_ptr(),
            *ints,
            mat.block,
            h.shape[1],
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {err}")
    cuda_build.launch_counts[kernel] += 1
    return out


def bsr_flat_matmul(mat: BsrFlat, h: torch.Tensor) -> torch.Tensor:
    """[n_row_blocks·B, F] float32 = flat-tile BSR(mat) @ h.

    CPU tensors take :func:`bsr_flat_matmul_plain`; CUDA tensors launch the
    kernel on the current stream and count the launch."""
    if h.device.type == "cpu":
        return bsr_flat_matmul_plain(mat, h)
    if tuple(mat.row_ptr.shape) != (mat.n_row_blocks + 1,):
        raise ValueError("row_ptr must have n_row_blocks + 1 entries")
    return _launch(
        KERNEL, "bsr_flat_matmul_f32", mat,
        (("colblk", mat.colblk), ("row_ptr", mat.row_ptr)), (mat.n_row_blocks,), h,
    )


def bsr_matmul(mat: BsrMatrix, h: torch.Tensor) -> torch.Tensor:
    """[n_row_blocks·B, F] float32 = padded-list BSR(mat) @ h.

    CPU tensors take :func:`bsr_matmul_plain`; CUDA tensors launch the
    kernel on the current stream and count the launch."""
    if h.device.type == "cpu":
        return bsr_matmul_plain(mat, h)
    if mat.tile_col.shape != mat.tile_idx.shape:
        raise ValueError("tile_idx and tile_col must have one shape")
    return _launch(
        KERNEL_PADDED, "bsr_matmul_f32", mat,
        (("tile_idx", mat.tile_idx), ("tile_col", mat.tile_col)),
        (mat.n_row_blocks, mat.k_max), h,
    )


class _TileCore(torch.autograd.Function):
    """out = BSR(mat) @ h_p; dh_p = BSR(mat_t) @ g — the backward is the
    same kernel on the transpose operand (the JAX package's ``_flat_bwd``
    and ``_spmm_bsr_bwd``). ``g`` has ``mat.n_rows_padded`` rows, which is
    ``mat_t.n_cols_padded``."""

    @staticmethod
    def forward(ctx, h_p, matmul, mat, mat_t):
        ctx.matmul, ctx.mat_t = matmul, mat_t
        return matmul(mat, h_p)

    @staticmethod
    def backward(ctx, g):
        return ctx.matmul(ctx.mat_t, g.contiguous()), None, None, None


def _spmm_tiles(matmul, mat, mat_t, h: torch.Tensor) -> torch.Tensor:
    f = h.shape[1]
    f_pad = _round_up(f, 128)
    rows = mat.n_cols_padded
    m = min(h.shape[0], rows)
    h_p = h if tuple(h.shape) == (rows, f_pad) else F.pad(h[:m], (0, f_pad - f, 0, rows - m))
    out = _TileCore.apply(h_p.contiguous(), matmul, mat, mat_t)
    return out[: mat.n_rows, :f]


def spmm_bsr_flat(mat: BsrFlat, mat_t: BsrFlat, h: torch.Tensor) -> torch.Tensor:
    """Flat-tile block-sparse SpMM, differentiable in ``h`` (``mat_t``
    drives the backward ``Âᵀ·G``; symmetric operators pass the same operand
    twice). Returns ``mat.n_rows`` rows of ``h``'s width."""
    return _spmm_tiles(bsr_flat_matmul, mat, mat_t, h)


def spmm_bsr(
    mat: BsrMatrix, mat_t: BsrMatrix, h: torch.Tensor, *, mxu_dtype=torch.float32
) -> torch.Tensor:
    """Padded-list block-sparse SpMM, differentiable in ``h`` (``mat_t``
    drives the backward). Pads ``h`` to ``mat.n_cols_padded`` rows and a
    multiple of 128 columns; returns ``mat.n_rows`` rows of ``h``'s width.
    The contraction is float32; ``mxu_dtype`` other than float32 (the JAX
    package's bf16 contraction) is not ported yet."""
    if mxu_dtype != torch.float32:
        raise NotImplementedError(
            f"spmm_bsr contracts in float32; mxu_dtype {mxu_dtype} comes with the "
            "bf16 contraction of the factorized-adjacency slice (ROADMAP.md)"
        )
    return _spmm_tiles(bsr_matmul, mat, mat_t, h)
