"""The 3×TF32 dense products (``graphconvgeo_torch/ops/dense.py``) on the CPU:
the kernel's arithmetic in plain PyTorch against float64, the autograd
Function's nn / nt / tn routing, the kernel's shape rules, and the rule that
keeps CPU tensors, short products and other dtypes on ``torch.matmul``. The
kernel itself (``csrc/dense_3xtf32.cu``) runs only on the card, where
``chip_smoke.py`` (phase 2, ``phase_dense``; ``--kernels`` stops after phase
2) holds it against float64 beside torch.matmul and one TF32 product, and
the Function against torch.autograd."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from graphconvgeo_torch.models import gcn
from graphconvgeo_torch.ops import ce_stream, dense
from graphconvgeo_torch.utils import cuda_build, profiling

# max |C − C64| / max |C64| of the sum of the three TF32 terms; one TF32
# product keeps 10 mantissa bits (about 2^-11 relative a term) and misses it
THREE_TERM_LIMIT = 2e-6


def _rand(shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x.double() - ref).abs().max() / ref.abs().max())


def _low_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) & 0x1FFF


def test_tf32_round_is_nearest_ties_away():
    one = 0x3F800000
    bits = np.array([one, one + 0x0FFF, one + 0x1000, one + 0x1001, one + 0x3000,
                     one | (1 << 31) | 0x1000, 0x7F800000, 0], dtype=np.uint32)
    got = dense.tf32_round(torch.from_numpy(bits.view(np.float32))).numpy().view(np.uint32)
    want = [one, one, one + 0x2000, one + 0x2000, one + 0x4000,
            (one | (1 << 31)) + 0x2000, 0x7F800000, 0]
    assert got.tolist() == want


@pytest.mark.parametrize("seed", [0, 1])
def test_split_parts_are_tf32_and_sum_to_x(seed):
    x = _rand((4096,), seed) * torch.logspace(-20, 20, 4096)
    hi, lo = dense.split_tf32(x)
    assert int(_low_bits(hi).abs().sum()) == 0 and int(_low_bits(lo).abs().sum()) == 0
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0**-21
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) <= 2.0**-11


def test_bf16_operand_has_no_lo_part():
    x = _rand((64, 32), 3, torch.bfloat16)
    hi, lo = dense.split_tf32(x)
    assert lo is None and hi.dtype == torch.float32
    assert torch.equal(dense.tf32_round(hi), hi)


@pytest.mark.parametrize("k,n", [(900, 900), (900, 930), (640, 900), (640, 930)])
def test_plain_three_terms_meet_the_limit_one_tf32_product_misses(k, n):
    a, b = _rand((96, k), k), _rand((k, n), n)
    ref = a.double() @ b.double()
    three = _rel(dense.plain_product(a, b), ref)
    one = _rel(dense.tf32_round(a) @ dense.tf32_round(b), ref)
    assert three <= THREE_TERM_LIMIT < one, (three, one)
    assert _rel(a @ b, ref) <= THREE_TERM_LIMIT


@pytest.mark.parametrize("da,db,terms", [
    (torch.float32, torch.float32, 3),
    (torch.bfloat16, torch.float32, 2),
    (torch.float32, torch.bfloat16, 2),
    (torch.bfloat16, torch.bfloat16, 1),
])
def test_plain_terms_follow_the_dtypes(da, db, terms, monkeypatch):
    a, b = _rand((80, 640), 5, da), _rand((640, 900), 6, db)
    products = []
    real = torch.Tensor.__matmul__
    monkeypatch.setattr(torch.Tensor, "__matmul__",
                        lambda x, y: products.append(1) or real(x, y))
    out = dense.plain_product(a, b)
    monkeypatch.undo()
    assert len(products) == terms and out.dtype == torch.float32
    assert _rel(out, a.double() @ b.double()) <= THREE_TERM_LIMIT


class _SpyOps:
    """PLAIN_OPS that records which product each call took."""

    def __init__(self):
        self.calls = []
        self.operand = dense.PLAIN_OPS.operand
        for name in ("nn", "nt", "tn"):
            setattr(self, name, self._wrap(name, getattr(dense.PLAIN_OPS, name)))

    def _wrap(self, name, fn):
        def call(x, y):
            self.calls.append((name, tuple(x.shape), tuple(y.shape)))
            return fn(x, y)
        return call


@pytest.mark.parametrize("n", [900, 930])
def test_function_routes_nn_nt_tn_like_autograd(n):
    a = _rand((200, 900), 7).requires_grad_()
    b = _rand((900, n), 8).requires_grad_()
    g = _rand((200, n), 9)
    ops = _SpyOps()
    out = dense.DenseProduct.apply(a, b, ops)
    out.backward(g)
    assert ops.calls == [("nn", (200, 900), (900, n)), ("nt", (200, n), (900, n)),
                         ("tn", (200, 900), (200, n))]
    a64, b64 = a.detach().double().requires_grad_(), b.detach().double().requires_grad_()
    (a64 @ b64).backward(g.double())
    assert _rel(out.detach(), (a64 @ b64).detach()) <= THREE_TERM_LIMIT
    assert _rel(a.grad, a64.grad) <= THREE_TERM_LIMIT
    assert _rel(b.grad, b64.grad) <= THREE_TERM_LIMIT
    a32, b32 = a.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
    torch.matmul(a32, b32).backward(g)
    assert torch.allclose(a.grad, a32.grad, rtol=1e-5, atol=1e-5 * float(a32.grad.abs().max()))
    assert torch.allclose(b.grad, b32.grad, rtol=1e-5, atol=1e-5 * float(b32.grad.abs().max()))


def test_function_slab_product_takes_only_the_weight_gradient():
    """The slab's product: a bf16 slab that needs no gradient and a bf16
    W0[cols] whose gradient comes back in bf16 (as the widened product's
    did): nn and tn only, the tn with 2 terms."""
    slab = _rand((300, 640), 10, torch.bfloat16)
    w = _rand((640, 900), 11, torch.bfloat16).requires_grad_()
    g = _rand((300, 900), 12)
    ops = _SpyOps()
    dense.DenseProduct.apply(slab, w, ops).backward(g)
    assert [c[0] for c in ops.calls] == ["nn", "tn"]
    assert w.grad.dtype == torch.bfloat16
    w32 = w.detach().float().requires_grad_()
    (slab.float() @ w32).backward(g)
    assert torch.equal(w.grad, w32.grad.to(torch.bfloat16)) or _rel(
        w.grad.float(), w32.grad.double()) <= 2.0**-8


def test_n_tile_covers_the_width_from_the_menu():
    assert dense.n_tile(900) == 152 and dense.n_tile(930) == 160 and dense.n_tile(640) == 160
    for n in range(1, 2000):
        w = dense.n_tile(n)
        tiles = math.ceil(n / w)
        assert w in dense.N_TILES and tiles == math.ceil(n / 160)
        assert tiles * w >= n and (tiles == 1 or (tiles - 1) * w < n)


@pytest.mark.parametrize("m,tiles", [(1_400_000, 32), (65_536, 32), (23_744, 32),
                                     (1_400_000, 20), (16_384, 1)])
def test_tn_splits_cover_the_rows_in_whole_stages(m, tiles):
    splits, rows = dense.tn_splits(m, tiles, 132)
    assert 1 <= splits <= 16 and rows % 32 == 0
    assert (splits - 1) * rows < m <= splits * rows


class _Like:
    """What ``engages`` reads of a tensor."""

    def __init__(self, rows, dtype, cuda=True, dims=2, cols=900):
        self.shape = (rows, cols)
        self.dtype = dtype
        self.is_cuda = cuda
        self._dims = dims

    def dim(self):
        return self._dims


@pytest.mark.parametrize("a,b,want", [
    (_Like(dense.MIN_ROWS, torch.float32), _Like(900, torch.float32), True),
    (_Like(1_400_000, torch.bfloat16), _Like(640, torch.bfloat16), True),
    (_Like(dense.MIN_ROWS - 1, torch.float32), _Like(900, torch.float32), False),
    (_Like(9_475, torch.float32), _Like(300, torch.float32), False),
    (_Like(1_400_000, torch.float32, cuda=False), _Like(900, torch.float32, cuda=False), False),
    (_Like(1_400_000, torch.float16), _Like(900, torch.float16), False),
    (_Like(1_400_000, torch.float64), _Like(900, torch.float32), False),
    (_Like(1_400_000, torch.float32), _Like(900, torch.float32, dims=3), False),
    # the weight's depth and width: the sampled outer conv (300 x 300) takes
    # the kernel, an output 129 or 32 wide and a depth of 299 do not
    (_Like(61_952, torch.float32, cols=300), _Like(300, torch.float32, cols=300), True),
    (_Like(dense.MIN_ROWS, torch.float32, cols=300), _Like(300, torch.float32, cols=129), False),
    (_Like(65_536, torch.float32), _Like(900, torch.float32, cols=32), False),
    (_Like(65_536, torch.float32, cols=dense.MIN_WIDTH - 1),
     _Like(dense.MIN_WIDTH - 1, torch.float32), False),
    (_Like(65_536, torch.bfloat16, cols=4096), _Like(4096, torch.bfloat16), True),
])
def test_engage_rule(a, b, want):
    assert dense.engages(a, b) is want


def test_cpu_products_stay_on_torch_matmul():
    cuda_build.reset_launch_counts()
    before = profiling.counters["dense_fallback"]
    a, b = _rand((dense.MIN_ROWS, 16), 13), _rand((16, 24), 14)
    assert torch.equal(gcn.matmul(a, b), a @ b)
    h, w = _rand((dense.MIN_ROWS, 16), 15), _rand((16, 8), 16, torch.bfloat16)
    assert torch.equal(ce_stream._head(h, w, torch.zeros(8)), h @ w.float())
    assert torch.equal(dense.matmul(w.t(), w, torch.bfloat16), w.t() @ w)
    assert all(cuda_build.launch_counts[k] == 0 for k in ("dense_nn", "dense_nt", "dense_tn"))
    assert profiling.counters["dense_fallback"] == before
