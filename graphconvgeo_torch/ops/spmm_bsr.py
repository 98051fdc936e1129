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
device) and gathers one row of h per nonzero, one warp per output row. Its
one C entry takes the packed arrays, h in float32 or bfloat16, and the
contraction: true float32 FFMA, or (``mxu_dtype=torch.bfloat16``, the JAX
package's 1-pass MXU contraction) every value and gathered element of h
rounded to bf16 first, then multiplied and summed in float32. The flat-tile
product counts its launches under ``bsr_flat_matmul`` or, with the bf16
contraction, ``bsr_flat_matmul_bf16``; the padded-list product under
``bsr_matmul`` in either contraction.

For each: ``*_plain`` is the dense-tile product in plain PyTorch (under
the bf16 contraction it multiplies ``tiles.bfloat16().float()`` by
``h.bfloat16().float()`` in float32; the CPU
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
import functools

import torch
import torch.nn.functional as F

from graphconvgeo_torch.sparse.formats import BsrFlat, BsrMatrix, PackedRows, _round_up
from graphconvgeo_torch.utils import cuda_build


KERNEL = "bsr_flat_matmul"
KERNEL_BF16 = "bsr_flat_matmul_bf16"
KERNEL_PADDED = "bsr_matmul"
# the kernel reads h in 4-column pieces and writes the output in float4;
# spmm_bsr* pad F to it
F_ALIGN = 4
# the contractions and h types the kernel takes
DTYPES = (torch.float32, torch.bfloat16)


def _bf16_contraction(mxu_dtype) -> bool:
    if mxu_dtype not in DTYPES:
        raise ValueError(f"mxu_dtype must be one of {DTYPES}, got {mxu_dtype}")
    return mxu_dtype == torch.bfloat16


def _contraction_operands(tiles: torch.Tensor, h: torch.Tensor, mxu_dtype) -> tuple:
    """The plain twins' float32 operands: as given, or rounded to bf16 (the
    kernel's and the MXU's bf16 contraction) and widened back."""
    if _bf16_contraction(mxu_dtype):
        return tiles.bfloat16().float(), h.bfloat16().float()
    return tiles, h.float()


def bsr_flat_matmul_plain(mat: BsrFlat, h: torch.Tensor, *, mxu_dtype=torch.float32) -> torch.Tensor:
    """[n_row_blocks·B, F] float32 = flat-tile BSR(mat) @ h, in plain
    PyTorch. ``h`` is [n_cols_padded, F]."""
    tiles, h = _contraction_operands(mat.tiles, h, mxu_dtype)
    b, f = mat.block, h.shape[1]
    prod = torch.bmm(tiles, h.reshape(-1, b, f)[mat.colblk.long()])
    out = torch.zeros(mat.n_row_blocks, b, f, dtype=prod.dtype, device=h.device)
    out.index_add_(0, mat.rowblk.long(), prod)
    return out.view(-1, f)


def bsr_matmul_plain(mat: BsrMatrix, h: torch.Tensor, *, mxu_dtype=torch.float32) -> torch.Tensor:
    """[n_row_blocks·B, F] float32 = padded-list BSR(mat) @ h, in plain
    PyTorch: one batched product over the row blocks per slot, summed in
    slot order. ``h`` is [n_cols_padded, F]."""
    tiles, h = _contraction_operands(mat.tiles, h, mxu_dtype)
    b, f = mat.block, h.shape[1]
    hb = h.reshape(-1, b, f)
    out = None
    for k in range(mat.k_max):
        part = torch.bmm(tiles[mat.tile_idx[:, k].long()], hb[mat.tile_col[:, k].long()])
        out = part if out is None else out + part
    return out.reshape(-1, f)


def _kernel_fn():
    fn = cuda_build.load("bsr_flat").bsr_packed_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(mat, packed: PackedRows, h: torch.Tensor) -> None:
    for name, t, dtypes in (
        ("row_ptr", packed.row_ptr, (torch.int32,)),
        ("col", packed.col, (torch.int32,)),
        ("val", packed.val, (torch.float32,)),
        ("h", h, DTYPES),
    ):
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
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


def _launch(kernel: str, mat, h: torch.Tensor, contract_bf16: bool) -> torch.Tensor:
    if h.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cpu or cuda, got {h.device}")
    if mat.tiles.device != h.device:
        raise ValueError(f"the operand is on {mat.tiles.device}, h on {h.device}")
    packed = mat.packed
    _check_cuda_operands(mat, packed, h)
    fn = _kernel_fn()
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
            int(h.dtype == torch.bfloat16),
            int(contract_bf16),
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {err}")
    cuda_build.launch_counts[kernel] += 1
    return out


def bsr_flat_matmul(mat: BsrFlat, h: torch.Tensor, *, mxu_dtype=torch.float32) -> torch.Tensor:
    """[n_row_blocks·B, F] float32 = flat-tile BSR(mat) @ h (float32 or
    bfloat16), contracted in ``mxu_dtype`` (float32 or bfloat16).

    CPU tensors take :func:`bsr_flat_matmul_plain`; CUDA tensors launch the
    packed-row kernel on ``mat.packed`` (built on the first launch) on the
    current stream and count the launch under ``bsr_flat_matmul`` or, with
    the bf16 contraction, ``bsr_flat_matmul_bf16``."""
    bf16 = _bf16_contraction(mxu_dtype)
    if h.device.type == "cpu":
        return bsr_flat_matmul_plain(mat, h, mxu_dtype=mxu_dtype)
    return _launch(KERNEL_BF16 if bf16 else KERNEL, mat, h, bf16)


def bsr_matmul(mat: BsrMatrix, h: torch.Tensor, *, mxu_dtype=torch.float32) -> torch.Tensor:
    """[n_row_blocks·B, F] float32 = padded-list BSR(mat) @ h, contracted
    in ``mxu_dtype``.

    CPU tensors take :func:`bsr_matmul_plain`; CUDA tensors launch the
    packed-row kernel on ``mat.packed`` (built on the first launch) on the
    current stream and count the launch under ``bsr_matmul``."""
    bf16 = _bf16_contraction(mxu_dtype)
    if h.device.type == "cpu":
        return bsr_matmul_plain(mat, h, mxu_dtype=mxu_dtype)
    return _launch(KERNEL_PADDED, mat, h, bf16)


class _TileCore(torch.autograd.Function):
    """out = BSR(mat) @ h_p; dh_p = BSR(mat_t) @ g — the backward is the
    same product (the same contraction) on the transpose operand (the JAX
    package's ``_flat_bwd`` and ``_spmm_bsr_bwd``). ``g`` has
    ``mat.n_rows_padded`` rows, which is ``mat_t.n_cols_padded``; autograd
    casts ``dh_p`` to ``h_p``'s dtype, as JAX's casts transpose."""

    @staticmethod
    def forward(ctx, h_p, matmul, mat, mat_t):
        ctx.matmul, ctx.mat_t = matmul, mat_t
        return matmul(mat, h_p)

    @staticmethod
    def backward(ctx, g):
        return ctx.matmul(ctx.mat_t, g.float().contiguous()), None, None, None


def _spmm_tiles(matmul, mat, mat_t, h: torch.Tensor, *, h_dtype=None) -> torch.Tensor:
    """Pad ``h`` to ``mat.n_cols_padded`` rows and a multiple of ``F_ALIGN``
    columns in ``h_dtype`` (the tiles' float32 unless given, as in JAX) and
    run ``matmul(mat, h_p)``; returns ``mat.n_rows`` rows of ``h``'s width."""
    h_dtype = mat.tiles.dtype if h_dtype is None else h_dtype
    f = h.shape[1]
    f_pad = _round_up(f, F_ALIGN)
    rows = mat.n_cols_padded
    m = min(h.shape[0], rows)
    if tuple(h.shape) == (rows, f_pad):
        h_p = h.to(h_dtype)
    else:
        h_p = F.pad(h[:m].to(h_dtype), (0, f_pad - f, 0, rows - m))
    out = _TileCore.apply(h_p.contiguous(), matmul, mat, mat_t)
    return out[: mat.n_rows, :f]


def spmm_bsr_flat(
    mat: BsrFlat, mat_t: BsrFlat, h: torch.Tensor, *, mxu_dtype=torch.float32, h_dtype=None
) -> torch.Tensor:
    """Flat-tile block-sparse SpMM, differentiable in ``h`` (``mat_t``
    drives the backward ``Âᵀ·G``; symmetric operators pass the same operand
    twice). ``mxu_dtype`` is the contraction (float32, or bfloat16: values
    and h rounded to bf16, float32 sums); ``h_dtype`` the type h reaches the
    kernel in (default the tiles' float32; bfloat16 sends a bf16 h without
    a float32 copy). Returns ``mat.n_rows`` float32 rows of ``h``'s width."""
    matmul = functools.partial(bsr_flat_matmul, mxu_dtype=mxu_dtype)
    return _spmm_tiles(matmul, mat, mat_t, h, h_dtype=h_dtype)


def spmm_bsr(
    mat: BsrMatrix, mat_t: BsrMatrix, h: torch.Tensor, *, mxu_dtype=torch.float32
) -> torch.Tensor:
    """Padded-list block-sparse SpMM, differentiable in ``h`` (``mat_t``
    drives the backward), contracted in ``mxu_dtype`` (float32 or
    bfloat16). h reaches the kernel in float32, as in JAX. Returns
    ``mat.n_rows`` rows of ``h``'s width."""
    return _spmm_tiles(functools.partial(bsr_matmul, mxu_dtype=mxu_dtype), mat, mat_t, h)
