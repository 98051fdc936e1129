"""Block-sparse SDDMM: the hand-written CUDA kernels and their plain twin.

Port of ``graphconvgeo_tpu/ops/sddmm_pallas.py :: sddmm_bsr``. SDDMM scores
the pairs of a sparsity pattern, ``s_ij = ⟨h1_i, h2_j⟩`` — the gradient of
SpMM in the edge values, and the score pass of attention-style layers. Over
a :class:`BsrMatrix` pattern the unit is the dense tile: for every
materialized tile t at (row block r, column block c)

    S[t] = H1[r·B : +B] @ H2[c·B : +B]ᵀ

in the pattern's tile layout ``[n_tiles + 1, B, B]``; tile 0 (the padding
tile) is zeros, and with ``mask_pattern`` the scores are multiplied by
``(pattern.tiles != 0)``.

- :func:`sddmm_bsr_plain` — the same function in plain PyTorch (one batched
  product over the gathered row and column blocks). The CPU path and the
  card-side check.
- :func:`sddmm_bsr` — the wrapper: a CPU tensor takes the plain version; a
  CUDA tensor launches a kernel of ``csrc/sddmm_bsr.cu`` and counts the
  launch, or raises. With ``mask_pattern`` the kernel scores only the
  pattern's nonzeros (the pattern's cached :attr:`BsrMatrix.tile_entries`,
  float32 FFMA) into a zeroed layout, so a call is one allocation and one
  launch; without it every entry of every tile is a score (the dense-tile
  kernel: 3×TF32 on the tensor cores, float32 accuracy as the JAX kernel's
  ``Precision.HIGHEST``). Both read h1 and h2 in place, unpadded; the
  dense-tile kernel takes F a multiple of ``F_ALIGN`` and 16-byte aligned
  rows, so the wrapper pads F to ``F_ALIGN`` only where it must.

One stated difference, with ``mask_pattern``: where h1 or h2 holds Inf or
NaN, the plain twin (and the JAX package) multiplies a non-finite score off
the pattern by 0 and gives NaN there, while the kernel writes an exact 0.
On finite inputs the two compute the same function.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from graphconvgeo_torch.sparse.formats import BsrMatrix, _round_up, tile_blocks
from graphconvgeo_torch.utils import cuda_build

KERNEL = "sddmm_bsr"
F_ALIGN = 4  # the dense-tile kernel's width: whole 16-byte copies a row
_JAX_F_ALIGN = 128  # the width the plain twin pads to, as the JAX package pads


def _pad(h: torch.Tensor, rows: int, f_pad: int) -> torch.Tensor:
    m = min(h.shape[0], rows)
    return F.pad(h[:m], (0, f_pad - h.shape[1], 0, rows - m)).contiguous()


def _padded_inputs(pattern: BsrMatrix, h1: torch.Tensor, h2: torch.Tensor) -> tuple:
    f_pad = _round_up(h1.shape[1], _JAX_F_ALIGN)
    return _pad(h1, pattern.n_rows_padded, f_pad), _pad(h2, pattern.n_cols_padded, f_pad)


def _dense_kernel_input(h: torch.Tensor) -> torch.Tensor:
    """``h`` as the dense-tile kernel reads it: itself where it is
    contiguous, 16-byte aligned and F a multiple of F_ALIGN, else a copy
    with F zero-padded to that multiple."""
    f = h.shape[1]
    if f % F_ALIGN == 0 and h.is_contiguous() and h.data_ptr() % 16 == 0:
        return h
    return F.pad(h, (0, _round_up(f, F_ALIGN) - f)).contiguous()


def sddmm_bsr_plain(
    pattern: BsrMatrix, h1: torch.Tensor, h2: torch.Tensor, *, mask_pattern: bool = True
) -> torch.Tensor:
    """[n_tiles + 1, B, B] float32 tile scores, in plain PyTorch. ``h1``
    rows follow the pattern's rows, ``h2`` rows its columns."""
    b = pattern.block
    h1p, h2p = _padded_inputs(pattern, h1, h2)
    trow, tcol = tile_blocks(pattern)
    a = h1p.view(-1, b, h1p.shape[1])[trow.long()]
    c = h2p.view(-1, b, h2p.shape[1])[tcol.long()]
    scores = torch.bmm(a, c.transpose(1, 2))
    scores[0] = 0.0
    if mask_pattern:
        scores = scores * (pattern.tiles != 0)
    return scores


def _kernel_fn(name: str, n_ptrs: int, n_ints: int):
    fn = getattr(cuda_build.load("sddmm_bsr"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(pattern: BsrMatrix, h1: torch.Tensor, h2: torch.Tensor) -> None:
    """What the kernels take: block 128 or 256, float32 [rows, F] inputs of
    one F, the pattern's tables on h1's device."""
    b = pattern.block
    if b not in (128, 256):
        raise ValueError(f"sddmm_bsr kernel takes block 128 or 256, got {b}")
    if h1.dim() != 2 or h2.dim() != 2 or h1.shape[1] != h2.shape[1]:
        raise ValueError(f"h1 and h2 must be [rows, F] of one F, got {tuple(h1.shape)}, {tuple(h2.shape)}")
    for name, t, dtype in (
        ("tile_idx", pattern.tile_idx, torch.int32),
        ("tile_col", pattern.tile_col, torch.int32),
        ("h1", h1, torch.float32),
        ("h2", h2, torch.float32),
    ):
        if t.device != h1.device:
            raise ValueError(f"{name} is on {t.device}, h1 on {h1.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(pattern.tiles.shape[1:]) != (b, b) or pattern.tiles.device != h1.device:
        raise ValueError(f"tiles must be [T, {b}, {b}] on {h1.device}, got "
                         f"{tuple(pattern.tiles.shape)} on {pattern.tiles.device}")


def sddmm_bsr(
    pattern: BsrMatrix,
    h1: torch.Tensor,
    h2: torch.Tensor,
    *,
    mask_pattern: bool = True,
) -> torch.Tensor:
    """[n_tiles + 1, B, B] float32 tile scores of ``pattern`` (see the
    module note). CPU tensors take :func:`sddmm_bsr_plain`; CUDA tensors
    launch a kernel on the current stream and count the launch."""
    if h1.device.type == "cpu":
        return sddmm_bsr_plain(pattern, h1, h2, mask_pattern=mask_pattern)
    if h1.device.type != "cuda":
        raise ValueError(f"sddmm_bsr runs on cpu or cuda, got {h1.device}")
    _check_cuda_args(pattern, h1, h2)
    b, n = pattern.block, pattern.tiles.shape[0]
    stream = torch.cuda.current_stream(h1.device).cuda_stream
    if mask_pattern:
        te = pattern.tile_entries
        h1, h2 = h1.contiguous(), h2.contiguous()
        out = torch.empty((n, b, b), dtype=torch.float32, device=h1.device)
        fn = _kernel_fn("sddmm_bsr_nz_f32", 7, 5)
        with torch.cuda.device(h1.device):
            err = fn(
                h1.data_ptr(), h2.data_ptr(), te.tile_ptr.data_ptr(), te.pos.data_ptr(),
                te.trow.data_ptr(), te.tcol.data_ptr(), out.data_ptr(),
                n, b, h1.shape[1], h1.shape[0], h2.shape[0], stream,
            )
    else:
        trow, tcol = pattern.tile_rowcol
        h1, h2 = _dense_kernel_input(h1), _dense_kernel_input(h2)
        out = torch.empty((n, b, b), dtype=torch.float32, device=h1.device)
        fn = _kernel_fn("sddmm_bsr_dense_f32", 5, 5)
        with torch.cuda.device(h1.device):
            err = fn(
                h1.data_ptr(), h2.data_ptr(), trow.data_ptr(), tcol.data_ptr(),
                out.data_ptr(), n, b, h1.shape[1], h1.shape[0], h2.shape[0], stream,
            )
    if err != 0:
        raise RuntimeError(f"sddmm_bsr kernel launch failed with CUDA error {err}")
    cuda_build.launch_counts[KERNEL] += 1
    return out
