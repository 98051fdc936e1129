"""The model's dense products on the tensor cores in 3×TF32.

The JAX package leaves ``h @ w`` to XLA at float32 precision. On the H100,
cuBLAS runs float32 products on the FFMA units. TF32 on the tensor cores is
7× faster but keeps 10 mantissa bits, which the port's check fails. 3×TF32
keeps float32's accuracy: each float32 operand x splits into hi =
tf32_rna(x) and lo = tf32_rna(x − hi), and lo·hi + hi·lo + hi·hi are summed
in float32 (lo·lo dropped). A bf16 operand is exact in TF32 and has no lo
part, so the terms follow the dtypes: 3 for f32·f32, 2 for bf16·f32, 1 for
bf16·bf16. The output is float32.

- :func:`matmul` — ``a @ b`` in a given dtype. It takes the kernel
  (``csrc/dense_3xtf32.cu``) when :func:`engages` holds: both operands on
  CUDA, 2-D, float32 or bf16, ``a`` with at least :data:`MIN_ROWS` rows and
  ``b`` with at least :data:`MIN_WIDTH` rows and columns. Otherwise
  ``torch.matmul`` keeps the product, as on the CPU; a float32 CUDA product
  sent there adds 1 to ``profiling.counters["dense_fallback"]``.
- :class:`DenseProduct` — the autograd Function: forward ``a @ b`` (nn),
  backward ``g @ bᵀ`` (nt) and ``aᵀ @ g`` (tn), on :data:`KERNEL_OPS` (each
  product adds 1 to ``cuda_build.launch_counts["dense_nn" | "dense_nt" |
  "dense_tn"]``; ``g`` is copied once into rows the kernel's TMA can read
  where its own cannot be, as the head's 930-wide gradient) or on
  :data:`PLAIN_OPS`.
- :func:`plain_product` — the kernel's arithmetic in plain PyTorch: TF32
  rounding by int32 bit operations, hi and lo, the terms by dtype. The CPU
  tests hold it against float64 and the Function's routing on it against
  torch.autograd; on the card ``chip_smoke.py`` holds the kernel against
  float64 beside torch.matmul, and the Function against torch.autograd.
"""

from __future__ import annotations

import ctypes
import functools
import math
import types

import torch

from graphconvgeo_torch.utils import cuda_build, profiling

KERNEL = "dense_3xtf32"
# Where the kernel takes the product, from the card's sweep of rows at the
# (K, N) the port's paths give (PERF.md §6). At K and N of 300, 900 and 930
# it leads torch.matmul in each of nn, nt and tn from the smallest swept
# rows, 4,096. MIN_ROWS stays above GeoText's 9,475 rows all the same: the
# GeoText paths keep torch.matmul, and no benchmark cell measures them; the
# World head's last row block (23,744 rows) takes the kernel.
MIN_ROWS = 16384
# At an output 129 wide the kernel's tn trails torch.matmul at every swept
# row count, at 32 wide its nt or tn from 12,288 rows. At a depth of 160
# its error against float64 meets torch.matmul's and at 64 reads twice it:
# the tensor cores sum each chain of products truncated, which sets a floor
# that torch.matmul's shorter sums stay under. K and N take the kernel from
# 300, the narrowest swept width at which it leads.
MIN_WIDTH = 300
_DTYPES = (torch.float32, torch.bfloat16)
N_TILES = (64, 128, 152, 160)  # the kernel's N-tiles (wgmma widths)
_K_BLOCK = 32  # the kernel's contraction depth a stage
_TN_MAX_SPLITS = 16


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: add half of the 13 bits
    dropped to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple:
    """(hi, lo) of float32 ``x``: hi = tf32(x), lo = tf32(x − hi); lo is
    None for a bf16 ``x``, whose values are exact in TF32 (hi is x in
    float32)."""
    if x.dtype == torch.bfloat16:
        return x.float(), None
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def plain_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel sums it: lo·hi + hi·lo + hi·hi of the TF32
    parts, each term a float32 product, the terms by dtype."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    out = a_hi @ b_hi
    if b_lo is not None:
        out = (a_hi @ b_lo) + out
    if a_lo is not None:
        out = (a_lo @ b_hi) + out
    return out


def n_tile(n: int) -> int:
    """The kernel's N-tile for an output ``n`` columns wide: the fewest
    tiles of at most 160 columns, each as narrow as the menu allows (900:
    6 × 152, 930: 6 × 160)."""
    tiles = -(-n // N_TILES[-1])
    need = -(-n // tiles)
    return next(w for w in N_TILES if w >= need)


def engages(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a @ b`` takes the kernel: both on CUDA, 2-D, float32 or
    bf16, ``a`` with at least MIN_ROWS rows and ``b`` at least MIN_WIDTH
    deep and wide."""
    return (
        a.is_cuda and b.is_cuda and a.dim() == 2 and b.dim() == 2
        and a.dtype in _DTYPES and b.dtype in _DTYPES and a.shape[0] >= MIN_ROWS
        and min(b.shape) >= MIN_WIDTH
    )


def matmul(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` in ``dtype``: on the kernel where :func:`engages` holds
    (summed in float32, then cast), else ``a.to(dtype) @ b.to(dtype)``."""
    if engages(a, b):
        return DenseProduct.apply(a, b, KERNEL_OPS).to(dtype)
    if a.is_cuda and dtype == torch.float32:
        profiling.counters["dense_fallback"] += 1
    return a.to(dtype) @ b.to(dtype)


class DenseProduct(torch.autograd.Function):
    """``a @ b`` in float32 on ``ops`` (KERNEL_OPS or PLAIN_OPS); the
    gradients are the same products, nt and tn, in ``a``'s and ``b``'s
    dtypes."""

    @staticmethod
    def forward(ctx, a, b, ops):
        ctx.ops = ops
        ctx.save_for_backward(a, b)
        return ops.nn(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = ctx.ops.operand(g)  # once for both products
        ga = ctx.ops.nt(g, b) if ctx.needs_input_grad[0] else None
        gb = ctx.ops.tn(a, g) if ctx.needs_input_grad[1] else None
        return ga, gb, None


PLAIN_OPS = types.SimpleNamespace(
    operand=lambda x: x,
    nn=plain_product,
    nt=lambda g, b: plain_product(g, b.t()),
    tn=lambda a, g: plain_product(a.t(), g),
)


# ---- the kernel ----------------------------------------------------------------
def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    fn = getattr(cuda_build.load(KERNEL), name)
    fn.argtypes = {
        "dense_split_weight": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p],
        "dense_rows": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p],
        "dense_tn": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _call(name: str, device, *args) -> None:
    with torch.cuda.device(device):
        err = _kernel_fn(name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        what = f"tensor map error {-err}" if err < 0 else f"CUDA error {err}"
        raise RuntimeError(f"{KERNEL} :: {name} failed ({what})")


def _rows_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel's TMA reads it: itself where its rows are unit
    stride with a 16-byte aligned base and row stride, else a copy into
    rows padded to 16 bytes (the pad is never read)."""
    size = x.element_size()
    if (x.stride(1) == 1 and x.stride(0) >= x.shape[1] and (x.stride(0) * size) % 16 == 0
            and x.data_ptr() % 16 == 0):
        return x
    cols = x.shape[1]
    out = torch.empty((x.shape[0], _round_up(cols, 16 // size)), dtype=x.dtype, device=x.device)
    out[:, :cols].copy_(x)
    return out[:, :cols]


def _is_bf16(x: torch.Tensor) -> int:
    return int(x.dtype == torch.bfloat16)


def _split_weight(w: torch.Tensor, s_c: int, s_o: int, kc: int, no: int) -> tuple:
    """(W_hi, W_lo or None) [no, Kp] of the logical weight [kc, no] with
    element (c, o) at ``w``'s storage offset c·s_c + o·s_o."""
    kp = _round_up(kc, _K_BLOCK)
    hi = torch.empty((no, kp), dtype=torch.float32, device=w.device)
    lo = None if w.dtype == torch.bfloat16 else torch.empty_like(hi)
    _call("dense_split_weight", w.device, w.data_ptr(), _is_bf16(w), s_c, s_o, kc, no, kp,
          hi.data_ptr(), 0 if lo is None else lo.data_ptr())
    return hi, lo


def _rows(a: torch.Tensor, w_hi: torch.Tensor, w_lo, k: int, n: int) -> torch.Tensor:
    a = _rows_operand(a)
    c = torch.empty((a.shape[0], n), dtype=torch.float32, device=a.device)
    _call("dense_rows", a.device, a.data_ptr(), _is_bf16(a), a.stride(0), a.shape[0], k,
          w_hi.data_ptr(), 0 if w_lo is None else w_lo.data_ptr(), w_hi.shape[1], n, n_tile(n),
          c.data_ptr())
    return c


def _check(*xs: torch.Tensor) -> None:
    for x in xs:
        if not (x.is_cuda and x.dim() == 2 and x.dtype in _DTYPES):
            raise ValueError(f"{KERNEL} takes 2-D float32 or bf16 CUDA tensors, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")


def kernel_nn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] on the kernel, float32 [M, N]."""
    _check(a, b)
    k, n = b.shape
    if a.shape[1] != k:
        raise ValueError(f"a {tuple(a.shape)} @ b {tuple(b.shape)}")
    w_hi, w_lo = _split_weight(b, b.stride(0), b.stride(1), k, n)
    cuda_build.launch_counts["dense_nn"] += 1
    return _rows(a, w_hi, w_lo, k, n)


def kernel_nt(g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """g [M, N] @ b [K, N]ᵀ on the kernel, float32 [M, K]."""
    _check(g, b)
    k, n = b.shape
    if g.shape[1] != n:
        raise ValueError(f"g {tuple(g.shape)} @ b {tuple(b.shape)}ᵀ")
    w_hi, w_lo = _split_weight(b, b.stride(1), b.stride(0), n, k)
    cuda_build.launch_counts["dense_nt"] += 1
    return _rows(g, w_hi, w_lo, n, k)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tn_splits(m: int, tiles: int, sms: int) -> tuple:
    """(splits, rows a split) of the tn product's m summed rows over
    ``tiles`` output tiles: the split count up to 16 whose CTAs fill the
    ``sms`` SMs' waves best (the fewest on a tie), each split a multiple of
    the kernel's 32 rows."""
    best = None
    for s in range(1, _TN_MAX_SPLITS + 1):
        rows = _round_up(-(-m // s), _K_BLOCK)
        used = -(-m // rows)
        ctas = used * tiles
        fill = ctas / (math.ceil(ctas / sms) * sms)
        if best is None or fill > best[0] + 1e-9:
            best = (fill, used, rows)
    return best[1], best[2]


def kernel_tn(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """a [M, K]ᵀ @ g [M, N] on the kernel, float32 [K, N], the M rows
    split over the SMs and the partial sums added in a fixed order."""
    _check(a, g)
    m, k = a.shape
    n = g.shape[1]
    if g.shape[0] != m or g.dtype != torch.float32:
        raise ValueError(f"a {tuple(a.shape)}ᵀ @ g {tuple(g.shape)} {g.dtype}")
    a, g = _rows_operand(a), _rows_operand(g)
    bn = n_tile(n)
    tiles = -(-k // 128) * -(-n // bn)
    splits, rows = tn_splits(m, tiles, _sm_count(a.device.index or 0))
    out = torch.empty((k, n), dtype=torch.float32, device=a.device)
    part = torch.empty((splits, k, n), dtype=torch.float32, device=a.device) if splits > 1 else out
    _call("dense_tn", a.device, a.data_ptr(), _is_bf16(a), a.stride(0), g.data_ptr(), g.stride(0),
          m, k, n, bn, splits, rows, part.data_ptr(), out.data_ptr())
    cuda_build.launch_counts["dense_tn"] += 1
    return out


KERNEL_OPS = types.SimpleNamespace(operand=_rows_operand, nn=kernel_nn, nt=kernel_nt, tn=kernel_tn)
