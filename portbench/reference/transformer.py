"""Plain reference of the graph transformer's full-graph training steps
(UniMP: Shi et al., *Masked Label Prediction: Unified Message Passing Model
for Semi-Supervised Classification*, IJCAI 2021, arXiv 2009.03509; the
model of the port's ``models/transformer.py``), written from the layer's
equations in plain PyTorch: dense GEMMs with TF32 off, the edge softmax
over edge lists a head and 2²¹ edges at a time with its backward written
out by hand, autograd through the rest of the layers and the head, the
input layer's backward by hand, and Adam as ``torch.optim.Adam`` defines
it::

    H₀ = ReLU(Xd · W₀ + b₀)                          Xd: X with the input dropout
    for each hidden layer l (heads c of f columns):
        D = dropout(Hₗ₋₁);  q, k, v, r = D W_q + b_q, D W_k + b_k, D W_v + b_v, D W_r + b_r
        α_c,ij = the softmax over row i's edges of ⟨q_c,i, k_c,j⟩ / √f, κ the attention dropout
        ĥ_i = concat_c Σ_j κα_c,ij v_c,j
        β_i = sigmoid([ĥ_i ; r_i ; ĥ_i − r_i] · w_g)
        Hₗ = ReLU(LayerNorm((1 − β) ĥ + β r))     (its mean and biased variance, ε 1e-5)
    loss = mean over the training rows of CE(dropout(H_L) W_out + b_out, y)

Departures from the paper, as the configuration states them: no masked
label input (it changes the task's inputs, not the block), no edge
features (the mention graph has none, so UniMP's e_ij terms are zero), the
dense output layer of the port where UniMP ends in an attention layer whose
heads are averaged, and self-loops in the attended pattern (Â's normalized
pattern holds them). The attention's backward: with c_i = ⟨g_i, ĥ_i⟩ and
ds_ij = α(κ⟨g_i, v_j⟩ − c_i), dq_i = Σ_j ds_ij k_j / √f, dk_j = Σ_i ds_ij
q_i / √f and dv_j = Σ_i κα_ij g_i.

The edges are Â's pattern with its self-loops, built from the mention
groups (``reference/gat.py :: Pattern``); the randomness is the
configuration's, drawn as ``reference/gat.py`` draws it: the input dropout
by the position hash, three dense masks a step from one generator (the two
layers' inputs, then the head's), the attention dropout by the hash of each
entry's id ``row · n + col + head · n²`` under :func:`attn_layer_seed`. The
stated roundings are the input layer's (``reference/gcn.py``); the rest is
float32. The only state of the program followed is its node order.

Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.gat import EDGE_CHUNK, Pattern, attn_keep, attn_layer_seed, tf32
from portbench.reference.gcn import InputMatrix, Problem, adam_steps, input_split, round_to

# "config": the configuration's precisions; "tf32": its GEMMs in TF32;
# "bf16attn": the attention aggregation's operands rounded to bf16
MODES = ("config", "tf32", "bf16attn")
LN_EPS = 1e-5


def _sddmm(pat: Pattern, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """⟨a_i, b_j⟩ over the edges (i, j), a block of edges at a time."""
    out = torch.empty(pat.nnz, device=a.device)
    for e0 in range(0, pat.nnz, EDGE_CHUNK):
        sl = slice(e0, min(e0 + EDGE_CHUNK, pat.nnz))
        out[sl] = (a[pat.rows[sl]] * b[pat.cols[sl]]).sum(1)
    return out


class _HeadAttention(torch.autograd.Function):
    """One head's attention over the pattern's edges: the softmax
    aggregation forward, its backward by hand (module docstring). ``rnd``
    rounds the aggregation's operands (κe and v; κα and g; g and v)."""

    @staticmethod
    def forward(ctx, q, k, v, pat, keep, scale, rnd):
        n = pat.n
        sc = _sddmm(pat, q, k) * scale
        mx = torch.full((n,), -torch.inf, device=q.device).scatter_reduce_(0, pat.rows, sc,
                                                                           "amax")
        e = torch.exp(sc - mx[pat.rows])
        del sc, mx
        den = torch.zeros(n, device=q.device).index_add_(0, pat.rows, e)
        ke = e if keep is None else e * keep
        out = torch.sparse.mm(pat.csr(round_to(ke, rnd)), round_to(v.contiguous(), rnd))
        out /= den[:, None]
        ctx.pat, ctx.keep, ctx.scale, ctx.rnd = pat, keep, scale, rnd
        ctx.save_for_backward(q, k, v, e, den, out)
        return out

    @staticmethod
    def backward(ctx, g):
        pat, keep, scale, rnd = ctx.pat, ctx.keep, ctx.scale, ctx.rnd
        q, k, v, e, den, out = ctx.saved_tensors
        g = g.contiguous()
        alpha = e / den[pat.rows]
        c = (g * out).sum(1)
        gv = _sddmm(pat, round_to(g, rnd), round_to(v, rnd))
        ka = alpha
        if keep is not None:
            gv, ka = gv * keep, alpha * keep
        ds = alpha * (gv - c[pat.rows]) * scale
        del gv
        dq = torch.sparse.mm(pat.csr(ds), k.contiguous())
        dk = torch.sparse.mm(pat.csr_t(ds), q.contiguous())
        dv = torch.sparse.mm(pat.csr_t(round_to(ka, rnd)), round_to(g, rnd))
        return dq, dk, dv, None, None, None, None


class Reference:
    """The training steps of one problem on a device. ``mode``: one of
    :data:`MODES`."""

    def __init__(self, p: Problem, device, *, mode: str = "config"):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        m = p.model
        self.p, self.mode, self.device = p, mode, torch.device(device)
        self.gather = "bf16" if p.gather_bf16 else None
        self.slab = "bf16" if p.slab_bf16 else None
        self.attn_round = "bf16" if mode == "bf16attn" else None
        self.heads = int(m["heads"])
        self.attn_rate = float(m.get("attn_dropout", 0.0))
        n = p.x.shape[0]
        self.pat = Pattern(n, p.groups, p.direct, self.device)
        self.slab_cols, self.hot_ids = input_split(p.x, p.model, p.layout)
        self.x = InputMatrix(p, self.device, self.slab, self.slab_cols, self.hot_ids)
        mask = torch.zeros(n, dtype=torch.float32, device=self.device)
        mask[torch.as_tensor(np.asarray(p.train_rows, np.int64), device=self.device)] = 1.0
        self.mask = mask
        self.y = torch.as_tensor(np.asarray(p.y, np.int64), device=self.device)

    def layout(self) -> dict:
        """The slab's and the hot cache's columns, the attention tiles and
        the rest's edges, worked out from the configuration's rules."""
        lay = self.p.layout
        return {"slab_cols": self.slab_cols, "hot_ids": self.hot_ids,
                **self.pat.tiles(lay["att_block"], lay["att_min_tile_nnz"])}

    def _dense_drop(self, h, keep):
        return torch.where(keep, h / (1.0 - self.p.dropout), torch.zeros((), device=h.device))

    def _layer(self, w: dict, i: int, h_in: torch.Tensor, seed: int) -> torch.Tensor:
        """Hidden layer ``i`` on its dropped input (autograd through all but
        the attention's edges)."""
        pat, heads, n = self.pat, self.heads, self.pat.n
        d = w[f"layers.{i}.wq"].shape[1]
        f = d // heads
        q, k, v, r = (h_in @ w[f"layers.{i}.w{x}"] + w[f"layers.{i}.b{x}"] for x in "qkvr")
        ids = pat.rows * n + pat.cols
        outs = []
        for h in range(heads):
            cols = slice(h * f, (h + 1) * f)
            keep = None
            if self.attn_rate > 0.0:
                keep = attn_keep(ids + h * n * n, seed, self.attn_rate)
            outs.append(_HeadAttention.apply(q[:, cols], k[:, cols], v[:, cols], pat, keep,
                                             float(np.float32(1.0 / np.sqrt(f))),
                                             self.attn_round))
        out = torch.cat(outs, 1)
        del outs
        wg = w[f"layers.{i}.wg"]
        beta = torch.sigmoid(out @ wg[:d] + r @ wg[d:2 * d] + (out - r) @ wg[2 * d:])
        mix = (1.0 - beta) * out + beta * r
        mu = mix.mean(1, keepdim=True)
        var = ((mix - mu) ** 2).mean(1, keepdim=True)
        y = (mix - mu) * torch.rsqrt(var + LN_EPS) * w[f"layers.{i}.ln_w"] + w[f"layers.{i}.ln_b"]
        return torch.relu(y)

    def loss_and_grads(self, w: dict, x_seed: int, gen: torch.Generator) -> tuple:
        """One step's loss (float) and gradients (a dict like ``w``)."""
        p = self.p
        rate = p.dropout
        # X·W₀ as reference/gcn.py computes it, then ReLU
        xd_slab, xd_rest, xdt = self.x.dropped(x_seed, rate)
        w0 = round_to(w["input.w"], self.gather)
        pre0 = round_to(torch.sparse.mm(xd_slab, round_to(w0, self.slab)), self.gather)
        pre0 += torch.sparse.mm(xd_rest, w0)
        pre0 += w["input.b"]
        del xd_slab, xd_rest
        h0 = torch.relu(pre0).requires_grad_()
        wl = {k: v.detach().requires_grad_() for k, v in w.items() if not k.startswith("input.")}
        h = h0
        for i in range(len(p.hidden)):
            keep = torch.rand(h.shape, generator=gen, device=h.device) < (1.0 - rate)
            h = self._layer(wl, i, self._dense_drop(h, keep), attn_layer_seed(x_seed, i))
        keep_o = torch.rand(h.shape, generator=gen, device=h.device) < (1.0 - rate)
        logits = self._dense_drop(h, keep_o) @ wl["out.w"] + wl["out.b"]
        del h, keep_o
        ce = torch.logsumexp(logits, -1) - logits.gather(1, self.y[:, None])[:, 0]
        loss = (ce * self.mask).sum() / self.mask.sum().clamp(min=1.0)
        del logits, ce
        loss.backward()
        grads = {k: v.grad for k, v in wl.items()}
        # the input layer by hand: dW₀ in W₀'s gather dtype from the cotangent
        # in it; the slab's rows also in the slab's dtype
        d0 = h0.grad * (pre0 > 0)
        grads["input.b"] = d0.sum(0)
        dw0 = torch.sparse.mm(xdt, round_to(d0, self.gather))
        if self.slab is not None and self.slab != self.gather:
            dw0 = torch.where(self.x.in_slab[:, None], round_to(dw0, self.slab), dw0)
        grads["input.w"] = round_to(dw0, self.gather)
        return float(loss.detach()), grads

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
