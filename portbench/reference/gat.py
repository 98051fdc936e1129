"""Plain reference of the GAT's full-graph training steps (Veličković et
al., *Graph Attention Networks*, ICLR 2018, arXiv 1710.10903; the model of
the port's ``models/gat.py``), written from the model's equations in plain
PyTorch: sparse-times-dense products, dense GEMMs with TF32 off, the edge
softmax over edge lists, a backward written out by hand and computed a head
and a block of edges at a time (so that it fits at 1.4M users and width 900
after the program's state is freed), and Adam as ``torch.optim.Adam``
defines it.

    H₀ = ELU(Xd · W₀ + b₀)                           Xd: X with the input dropout
    for each hidden layer i (heads m, width f a head):
        Dᵢ = dropout(Hᵢ₋₁),  Z = Dᵢ Wᵢ,  Z_h its columns h·f … (h+1)·f
        e_jk = LeakyReLU_0.2((Z_h a_src,h)_j + (Z_h a_dst,h)_k)   each edge (j, k)
        α = the softmax of e over each row's edges, κ the attention dropout
        Hᵢ = ELU(concat_h Σ_k κ_jk α_jk Z_h,k + bᵢ) + Hᵢ₋₁
    loss = mean over the training rows of CE(dropout(H_L) W_out + b_out, y)

The edges are Â's pattern with its self-loops: A = binarize(offdiag(B Bᵀ) +
Dir + Dirᵀ), built here from the mention groups and direct edges
(``reference/gcn.py :: Adjacency``); the reference never sees the port's
operands. The softmax is the exact one over each row's edges, the backward
its chain rule: dα = κ·⟨g_j, Z_k⟩, c_j = ⟨g_j, Σ_k κα Z_k⟩, draw = α(dα −
c)·LeakyReLU'(raw), ds_j = Σ_k draw, dd_k = Σ_j draw, dZ_k = Σ_j κα g_j.

The randomness is the configuration's (as ``reference/gcn.py`` draws it):
the sparse input's dropout by the position-keyed hash under the step's
integer seed, one a step from ``numpy.random.default_rng(seed).integers(0,
2**31 - 1)``; three dense masks a step by ``torch.rand`` from one generator
seeded with ``seed`` (the two layers' inputs, then the head's); and the
attention dropout by Wang's hash of each entry's id ``row · n + col + head ·
n²`` (low 32 bits) under the layer's seed :func:`attn_layer_seed`, an entry
kept where the hash's top 31 bits reach ``rate · 2³¹``. The stated roundings
are the input layer's (``reference/gcn.py``); the attention is float32. The
only state of the program followed is its node order.

Imports nothing of the port.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference.gcn import (
    HEAD_ROWS,
    M32,
    Adjacency,
    InputMatrix,
    Problem,
    _in_tiles,
    _n_blocks,
    adam_steps,
    input_split,
    round_to,
    wang_hash,
)

# "config": the configuration's precisions; "tf32": its GEMMs in TF32;
# "bf16attn": the aggregation's operands rounded to bf16 (kernels 3–5′)
MODES = ("config", "tf32", "bf16attn")
EDGE_CHUNK = 1 << 21  # edges an SDDMM block gathers at once


def attn_layer_seed(x_seed: int, layer: int) -> int:
    """Hidden layer ``layer``'s attention-dropout seed at a step whose input
    dropout has the seed ``x_seed``."""
    return ((x_seed ^ 0x5BD1E995) + 0x9E3779B1 * (layer + 1)) & 0x7FFFFFFF


def attn_keep(ids: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """keep / (1 − rate) of the entries with ids ``ids`` (low 32 bits): the
    hash of the id xor the seed's hash, kept where its top 31 bits reach
    ``rate · 2³¹``."""
    s = wang_hash(torch.tensor(int(seed) & M32, dtype=torch.int64, device=ids.device))
    h = wang_hash((ids & M32) ^ s)
    thr = min(int(rate * (1 << 31)), (1 << 31) - 1)
    return ((h >> 1) >= thr).float() / (1.0 - rate)


def _leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def _elu_grad(x: torch.Tensor) -> torch.Tensor:
    """ELU's derivative at ``x`` (α = 1)."""
    return torch.where(x > 0, torch.ones((), device=x.device), torch.exp(x))


class Pattern:
    """Â's pattern as the layers attend over it: A's off-diagonal entries
    and the self-loops, as edge lists sorted by row (then column), with the
    order of the transpose."""

    def __init__(self, n: int, groups: list, direct: tuple, device):
        a = Adjacency(n, groups, direct, device).a
        dev = a.device
        rows = torch.repeat_interleave(torch.arange(n, device=dev), a.crow_indices().diff())
        diag = torch.arange(n, device=dev)
        key = torch.sort(torch.cat([rows * n + a.col_indices(), diag * n + diag])).values
        del a, rows
        self.n, self.nnz = n, int(key.numel())
        self.rows, self.cols = key // n, key % n
        del key
        self.crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        self.crow[1:] = torch.cumsum(torch.bincount(self.rows, minlength=n), 0)
        self.t_order = torch.argsort(self.cols * n + self.rows)
        self.t_crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        self.t_crow[1:] = torch.cumsum(torch.bincount(self.cols, minlength=n), 0)
        self.t_rows = self.rows[self.t_order]

    def csr(self, vals: torch.Tensor) -> torch.Tensor:
        """The pattern with the edges' values ``vals`` as a CSR tensor."""
        return torch.sparse_csr_tensor(self.crow, self.cols, vals, size=(self.n, self.n))

    def csr_t(self, vals: torch.Tensor) -> torch.Tensor:
        """The transpose, the edges' values ``vals`` given in row order."""
        return torch.sparse_csr_tensor(self.t_crow, self.t_rows, vals[self.t_order],
                                       size=(self.n, self.n))

    def tiles(self, block: int, min_nnz: int) -> dict:
        """The ``block``² blocks holding at least ``min_nnz`` edges (the
        kernels' tiles) and the edges outside them (the bucketed rest)."""
        inside = _in_tiles(self.rows, self.cols, block, min_nnz)
        return {"att_tiles": _n_blocks(self.rows[inside], self.cols[inside], block),
                "att_rest_edges": int((~inside).sum())}


@contextlib.contextmanager
def tf32(on: bool):
    """float32 GEMMs (and cuDNN) in TF32 (``on``) or in float32 inside the
    block."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


class Reference:
    """The training steps of one problem on a device. ``mode``: one of
    :data:`MODES`."""

    def __init__(self, p: Problem, device, *, mode: str = "config"):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        m = p.model
        if m.get("activation", "elu") != "elu":
            raise ValueError(f"the reference runs ELU, not {m['activation']!r}")
        self.p, self.mode, self.device = p, mode, torch.device(device)
        self.gather = "bf16" if p.gather_bf16 else None
        self.slab = "bf16" if p.slab_bf16 else None
        self.attn_round = "bf16" if mode == "bf16attn" else None
        self.heads = int(m["heads"])
        self.slope = float(m.get("negative_slope", 0.2))
        self.attn_rate = float(m.get("attn_dropout", 0.0))
        self.residual = bool(m.get("residual", True))
        n = p.x.shape[0]
        self.pat = Pattern(n, p.groups, p.direct, self.device)
        self.slab_cols, self.hot_ids = input_split(p.x, p.model, p.layout)
        self.x = InputMatrix(p, self.device, self.slab, self.slab_cols, self.hot_ids)
        mask = torch.zeros(n, dtype=torch.float32, device=self.device)
        mask[torch.as_tensor(np.asarray(p.train_rows, np.int64), device=self.device)] = 1.0
        self.mask = mask
        self.y = torch.as_tensor(np.asarray(p.y, np.int64), device=self.device)

    def layout(self) -> dict:
        """What the reference worked out of the operands' layout, for a
        comparison with the program's: the slab's and the hot cache's
        columns, the attention tiles and the rest's edges."""
        lay = self.p.layout
        return {"slab_cols": self.slab_cols, "hot_ids": self.hot_ids,
                **self.pat.tiles(lay["att_block"], lay["att_min_tile_nnz"])}

    def _dense_drop(self, h, keep):
        return torch.where(keep, h / (1.0 - self.p.dropout), torch.zeros((), device=h.device))

    def _attend(self, w: dict, i: int, h_in: torch.Tensor, seed: int) -> tuple:
        """Layer ``i``'s Z, its aggregation and, a head each, what the
        backward needs: (raw scores, exp(score − row max), row sums, κ or
        None), all over the edges."""
        pat, heads, n = self.pat, self.heads, self.pat.n
        z = h_in @ w[f"layers.{i}.w"]
        f = z.shape[1] // heads
        agg = torch.empty_like(z)
        ids = pat.rows * n + pat.cols
        parts = []
        for h in range(heads):
            zh = z[:, h * f:(h + 1) * f]
            raw = (zh @ w[f"layers.{i}.a_src"][h])[pat.rows] + (zh @ w[f"layers.{i}.a_dst"][h])[
                pat.cols]
            sc = _leaky(raw, self.slope)
            mx = torch.full((n,), -torch.inf, device=z.device).scatter_reduce_(
                0, pat.rows, sc, "amax")
            e = torch.exp(sc - mx[pat.rows])
            del sc, mx
            den = torch.zeros(n, device=z.device).index_add_(0, pat.rows, e)
            kap = None
            if self.attn_rate > 0.0:
                kap = attn_keep(ids + h * n * n, seed, self.attn_rate)
            ke = e if kap is None else e * kap
            agg[:, h * f:(h + 1) * f] = torch.sparse.mm(
                pat.csr(round_to(ke, self.attn_round)),
                round_to(zh.contiguous(), self.attn_round)) / den[:, None]
            parts.append((raw, e, den, kap))
        return z, agg, parts

    def _sddmm(self, g: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """⟨g_j, z_k⟩ over the edges (j, k), a block of edges at a time."""
        pat = self.pat
        out = torch.empty(pat.nnz, device=g.device)
        for e0 in range(0, pat.nnz, EDGE_CHUNK):
            sl = slice(e0, min(e0 + EDGE_CHUNK, pat.nnz))
            out[sl] = (g[pat.rows[sl]] * z[pat.cols[sl]]).sum(1)
        return out

    def _attend_bwd(self, w: dict, grads: dict, i: int, z, agg, parts, g) -> torch.Tensor:
        """dZ of layer ``i`` from the cotangent ``g`` of its aggregation;
        adds the attention vectors' gradients to ``grads``."""
        pat, heads = self.pat, self.heads
        f = z.shape[1] // heads
        dz = torch.empty_like(z)
        for h, (raw, e, den, kap) in enumerate(parts):
            cols = slice(h * f, (h + 1) * f)
            zh, gh = z[:, cols], g[:, cols]
            alpha = e / den[pat.rows]
            c = (gh * agg[:, cols]).sum(1)
            da = self._sddmm(round_to(gh, self.attn_round), round_to(zh, self.attn_round))
            ka = alpha
            if kap is not None:
                da = da * kap
                ka = alpha * kap
            draw = alpha * (da - c[pat.rows]) * torch.where(raw >= 0, 1.0, self.slope)
            del da
            ds = torch.zeros(pat.n, device=z.device).index_add_(0, pat.rows, draw)
            dd = torch.zeros(pat.n, device=z.device).index_add_(0, pat.cols, draw)
            del draw
            dzh = torch.sparse.mm(pat.csr_t(round_to(ka, self.attn_round)),
                                  round_to(gh.contiguous(), self.attn_round))
            a_src, a_dst = w[f"layers.{i}.a_src"][h], w[f"layers.{i}.a_dst"][h]
            dz[:, cols] = dzh + ds[:, None] * a_src + dd[:, None] * a_dst
            grads[f"layers.{i}.a_src"][h] += ds @ zh
            grads[f"layers.{i}.a_dst"][h] += dd @ zh
        return dz

    def loss_and_grads(self, w: dict, x_seed: int, gen: torch.Generator) -> tuple:
        """One step's loss (float) and gradients (a dict like ``w``)."""
        p = self.p
        rate = p.dropout
        n_layers = len(p.hidden)
        n = p.x.shape[0]
        seeds = [attn_layer_seed(x_seed, i) for i in range(n_layers)]
        xd_slab, xd_rest, xdt = self.x.dropped(x_seed, rate)
        # X·W₀ as reference/gcn.py computes it, then ELU
        w0 = round_to(w["input.w"], self.gather)
        pre0 = round_to(torch.sparse.mm(xd_slab, round_to(w0, self.slab)), self.gather)
        pre0 += torch.sparse.mm(xd_rest, w0)
        pre0 += w["input.b"]
        h = torch.nn.functional.elu(pre0)
        del xd_slab, xd_rest
        hs, keeps = [h], []
        for i in range(n_layers):
            keep = torch.rand(h.shape, generator=gen, device=h.device) < (1.0 - rate)
            _, agg, _ = self._attend(w, i, self._dense_drop(h, keep), seeds[i])
            out = torch.nn.functional.elu(agg + w[f"layers.{i}.b"])
            del agg
            h = out + h if self.residual and out.shape == h.shape else out
            hs.append(h)
            keeps.append(keep)
        # the head, as reference/gcn.py computes it
        keep_o = torch.rand(h.shape, generator=gen, device=h.device) < (1.0 - rate)
        count = self.mask.sum().clamp(min=1.0)
        grads = {k: torch.zeros_like(v) for k, v in w.items()}
        g = torch.empty_like(h)
        num = torch.zeros((), dtype=torch.float64, device=h.device)
        for r0 in range(0, n, HEAD_ROWS):
            sl = slice(r0, min(r0 + HEAD_ROWS, n))
            hd = self._dense_drop(h[sl], keep_o[sl])
            logits = hd @ w["out.w"] + w["out.b"]
            m = self.mask[sl]
            lse = torch.logsumexp(logits, dim=-1)
            ce = lse - logits.gather(1, self.y[sl, None])[:, 0]
            num += (ce * m).sum(dtype=torch.float64)
            d = torch.softmax(logits, dim=-1)
            d[torch.arange(d.shape[0], device=d.device), self.y[sl]] -= 1.0
            d *= (m / count)[:, None]
            grads["out.w"] += hd.T @ d
            grads["out.b"] += d.sum(0)
            g[sl] = self._dense_drop(d @ w["out.w"].T, keep_o[sl])
            del hd, logits, d
        loss = float(num / count.double())
        del keep_o
        for i in reversed(range(n_layers)):
            h_prev, keep = hs[i], keeps[i]
            h_in = self._dense_drop(h_prev, keep)
            z, agg, parts = self._attend(w, i, h_in, seeds[i])
            gpre = g * _elu_grad(agg + w[f"layers.{i}.b"])
            if not (self.residual and hs[i + 1].shape == h_prev.shape):
                g = torch.zeros_like(h_prev)
            grads[f"layers.{i}.b"] += gpre.sum(0)
            dz = self._attend_bwd(w, grads, i, z, agg, parts, gpre)
            del z, agg, parts, gpre
            grads[f"layers.{i}.w"] += h_in.T @ dz
            del h_in
            g += self._dense_drop(dz @ w[f"layers.{i}.w"].T, keep)
            del dz
            hs[i + 1] = None
        d0 = g * _elu_grad(pre0)
        grads["input.b"] += d0.sum(0)
        # dW₀ in W₀'s gather dtype from the cotangent in it; the slab's rows
        # also in the slab's dtype
        dw0 = torch.sparse.mm(xdt, round_to(d0, self.gather))
        if self.slab is not None and self.slab != self.gather:
            dw0 = torch.where(self.x.in_slab[:, None], round_to(dw0, self.slab), dw0)
        grads["input.w"] += round_to(dw0, self.gather)
        return loss, grads

    def run(self, w0: dict, steps: int = 3) -> dict:
        """``steps`` Adam steps from the weights ``w0`` (not modified), as
        ``reference/gcn.py :: adam_steps`` returns them."""
        p = self.p
        seeds = np.random.default_rng(p.seed)
        gen = torch.Generator(device=self.device).manual_seed(p.seed)

        def step(w):
            return self.loss_and_grads(w, int(seeds.integers(0, 2**31 - 1)), gen)

        with tf32(self.mode == "tf32"):
            return adam_steps(w0, p.lr, steps, step)
