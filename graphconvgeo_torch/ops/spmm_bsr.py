"""Block-sparse SpMM: the hand-written CUDA kernel and the plain twins.

Two products over densified ``B × B`` tiles:

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

On the card both run one packed-row gather kernel (``csrc/bsr_flat.cu``):
the operand's tiles are well under 1% full, so instead of multiplying
dense tiles the kernel reads the operand's :attr:`packed` rows
(:class:`~graphconvgeo_torch.sparse.formats.PackedRows`: the tiles'
nonzeros as row_ptr / col / val, built once per operand instance on its
device) and gathers one row of h per nonzero, one warp per output row, in
true float32 FFMA. Its two C entries take the same packed arrays.

For each: ``*_plain`` is the dense-tile product in plain PyTorch (the CPU
path and the card-side check, so the card holds the pack and the kernel
against the tiles themselves); the wrapper takes the plain version for a
CPU tensor and, for a CUDA tensor, launches the kernel and counts the
launch, or raises — there is no fallback from one to the other; ``spmm_*``
pads ``h`` to the tile grid's rows and a multiple of ``F_ALIGN`` columns
and runs the product through an autograd
Function whose backward is the same kernel on the transpose operand
(``Âᵀ·G``).

The kernel and the plain twin compute the same function; they differ only
where h holds a non-finite value: the dense twin spreads ``0·Inf = NaN``
over every row of a row block whose tiles touch that column block, the
kernel gives the sparse answer (as ``spmm_oracle``, the ``ell`` backend
and ``torch.sparse.mm`` do).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from graphconvgeo_torch.sparse.formats import BsrFlat, BsrMatrix, PackedRows, _round_up
from graphconvgeo_torch.utils import cuda_build

KERNEL = "bsr_flat_matmul"
KERNEL_PADDED = "bsr_matmul"
# the kernel reads h and writes the output in float4; spmm_bsr* pad F to it
F_ALIGN = 4


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


def _kernel_fn(name: str):
    fn = getattr(cuda_build.load("bsr_flat"), name)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(mat, packed: PackedRows, h: torch.Tensor) -> None:
    for name, t, dtype in (
        ("row_ptr", packed.row_ptr, torch.int32),
        ("col", packed.col, torch.int32),
        ("val", packed.val, torch.float32),
        ("h", h, torch.float32),
    ):
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(packed.row_ptr.shape) != (mat.n_rows_padded + 1,):
        raise ValueError(f"row_ptr must have n_rows_padded + 1 = {mat.n_rows_padded + 1} entries")
    if packed.val.shape != packed.col.shape:
        raise ValueError("col and val must have one length")
    if h.dim() != 2 or h.shape[0] != mat.n_cols_padded or h.shape[1] % F_ALIGN:
        raise ValueError(
            f"h must be [{mat.n_cols_padded}, multiple of {F_ALIGN}], got {tuple(h.shape)}"
        )
    if h.data_ptr() % 16:
        raise ValueError("h must be 16-byte aligned")


def _launch(kernel: str, name: str, mat, h: torch.Tensor) -> torch.Tensor:
    if h.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cpu or cuda, got {h.device}")
    if mat.tiles.device != h.device:
        raise ValueError(f"the operand is on {mat.tiles.device}, h on {h.device}")
    packed = mat.packed
    _check_cuda_operands(mat, packed, h)
    fn = _kernel_fn(name)
    out = torch.empty((mat.n_rows_padded, h.shape[1]), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        err = fn(
            packed.row_ptr.data_ptr(),
            packed.col.data_ptr(),
            packed.val.data_ptr(),
            h.data_ptr(),
            out.data_ptr(),
            mat.n_rows_padded,
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
    packed-row kernel on ``mat.packed`` (built on the first launch) on the
    current stream and count the launch."""
    if h.device.type == "cpu":
        return bsr_flat_matmul_plain(mat, h)
    return _launch(KERNEL, "bsr_flat_matmul_f32", mat, h)


def bsr_matmul(mat: BsrMatrix, h: torch.Tensor) -> torch.Tensor:
    """[n_row_blocks·B, F] float32 = padded-list BSR(mat) @ h.

    CPU tensors take :func:`bsr_matmul_plain`; CUDA tensors launch the
    packed-row kernel on ``mat.packed`` (built on the first launch) on the
    current stream and count the launch."""
    if h.device.type == "cpu":
        return bsr_matmul_plain(mat, h)
    return _launch(KERNEL_PADDED, "bsr_matmul_f32", mat, h)


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
    f_pad = _round_up(f, F_ALIGN)
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
    multiple of ``F_ALIGN`` columns; returns ``mat.n_rows`` rows of ``h``'s width.
    The contraction is float32; ``mxu_dtype`` other than float32 (the JAX
    package's bf16 contraction) is not ported yet."""
    if mxu_dtype != torch.float32:
        raise NotImplementedError(
            f"spmm_bsr contracts in float32; mxu_dtype {mxu_dtype} comes with the "
            "bf16 contraction of the factorized-adjacency slice (ROADMAP.md)"
        )
    return _spmm_tiles(bsr_matmul, mat, mat_t, h)
