"""UniMP's graph transformer as a geolocation model (``nn.Module``).

The graph transformer layer of Shi et al., *Masked Label Prediction: Unified
Message Passing Model for Semi-Supervised Classification*, IJCAI 2021
(arXiv 2009.03509; PyG's ``TransformerConv(beta=True)``), over the same
data pipeline, input layer, trainer and evaluation as :class:`HighwayGCN`::

    H₀ = ReLU( X · W₀ + b₀ )                       # shared sparse input layer
    for each hidden layer l (heads c of f = d/C columns), on D = dropout(Hₗ₋₁):
        q = D W_q + b_q,  k = D W_k + b_k,  v = D W_v + b_v,  r = D W_r + b_r
        α_c,ij = softmax over j ∈ N(i) of ⟨q_c,i, k_c,j⟩ / √f   (attention dropout κ)
        ĥ_i = ‖_c Σ_j κα_c,ij v_c,j
        β_i = sigmoid( w_g · [ĥ_i ; r_i ; ĥ_i − r_i] )
        Hₗ = ReLU( LayerNorm( (1 − β) ĥ + β r ) )
    logits = H_L W_out + b_out

N(i) is Â's pattern with its self-loops; the mention graph has no edge
features, so UniMP's edge terms are zero, and its masked label input (a
change of the task's inputs, not of the block) is left out. The four
projections run as one product ``D · [W_q | W_k | W_v | W_r]`` on
``ops/dense.py`` (3×TF32 on the card from ``dense.MIN_ROWS`` rows); the
attention reads q, k and v in place from it and walks the tiled pattern's
whole edge lists on every device (``ops/attention_dot.py``:
``_TiledDotAttnCore``, three CUDA kernels on the card). The gate's
``w_g · [ĥ; r; ĥ − r]`` is computed as ``ĥ·(w₁ + w₃) + r·(w₂ − w₃)``, so no
[n, 3d] array is made. Parameters: ``input.w/b``, ``layers.<i>.{wq, bq, wk,
bk, wv, bv, wr, br, wg, ln_w, ln_b}`` and ``out.w/b``; Glorot-uniform
weights ([in, out]; ``wg`` is [3d, 1]), zero biases, LayerNorm weights 1.
The model has :class:`HighwayGCN`'s surface, so ``Trainer`` and
``predict_classes`` take it unchanged. ``cfg.remat`` recomputes each layer in
the backward (its attention dropout is keyed by the layer's integer seed,
``models/gat.py :: attn_layer_seed``, so the recompute draws the same
mask); the dense dropout of its input stays outside the checkpoint. Each
layer is the profiler range ``tx_<i>``; the attention operand's build is
the span ``operands.attention``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from graphconvgeo_torch.models.gat import attn_layer_seed
from graphconvgeo_torch.models.gcn import (
    Params,
    _glorot,
    check_shared_fields,
    input_operands_of,
    matmul,
    sparse_input_layer,
    torch_dtype,
)
from graphconvgeo_torch.ops.attention_dot import dot_attention_tiled
from graphconvgeo_torch.ops.ce_stream import masked_ce_sums, streamed_rows_threshold
from graphconvgeo_torch.ops.dropout import dropout
from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern
from graphconvgeo_torch.sparse.formats import SparseGraph, to_device
from graphconvgeo_torch.utils.device import resolve_device
from graphconvgeo_torch.utils.profiling import span

LN_EPS = 1e-5  # LayerNorm's epsilon (torch.nn.LayerNorm's and PyG's default)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    n_features: int
    n_classes: int
    hidden: tuple = (300, 300)  # per-layer widths (= heads · per-head width), all equal
    heads: int = 4
    dropout: float = 0.5
    attn_dropout: float = 0.0  # dropout on the attention coefficients
    l2: float = 0.0
    dtype: str = "float32"  # the parameters' and the input layer's output dtype
    # cast W₀ to this dtype for the input layer's gathers (sums stay float32)
    gather_dtype: Optional[str] = None
    remat: bool = False  # recompute each layer in the backward
    # the shared input layer's options (see GCNConfig)
    input_hot_cache: bool = False
    input_backend: str = "auto"
    slab_cols: int = 4096
    slab_dtype: str = "float32"
    slab_byte_budget: int = 2 << 30

    def __post_init__(self):
        if any(h % self.heads for h in self.hidden):
            raise ValueError(
                f"hidden dims must be divisible by heads={self.heads}, got {self.hidden}")
        if len(set(self.hidden)) != 1:
            raise ValueError(f"the graph transformer needs equal hidden sizes, got {self.hidden}")
        if self.dtype != "float32":
            raise ValueError(f"the graph transformer runs in float32, got dtype {self.dtype!r}")
        check_shared_fields(self)


def init_transformer_params(module: nn.Module, cfg: TransformerConfig,
                            gen: torch.Generator) -> None:
    """Register the graph transformer's parameters on ``module`` (``input``,
    ``layers``, ``out``): Glorot-uniform weights, zero biases, LayerNorm
    weights 1, from a torch generator, in float32."""
    d = cfg.hidden[0]
    module.input = Params(w=_glorot((cfg.n_features, d), gen), b=torch.zeros(d))
    layers = []
    for _ in cfg.hidden:
        p = {}
        for name in ("q", "k", "v", "r"):
            p[f"w{name}"] = _glorot((d, d), gen)
            p[f"b{name}"] = torch.zeros(d)
        p["wg"] = _glorot((3 * d, 1), gen)
        p["ln_w"] = torch.ones(d)
        p["ln_b"] = torch.zeros(d)
        layers.append(Params(**p))
    module.layers = nn.ModuleList(layers)
    module.out = Params(w=_glorot((d, cfg.n_classes), gen), b=torch.zeros(cfg.n_classes))


def unimp_layer(att, layer: nn.Module, h_in: torch.Tensor, *, heads: int, attn_dropout: float,
                seed: int) -> torch.Tensor:
    """One UniMP layer on its (dropped) input h_in [n, d] → [n, d]."""
    d = layer.wq.shape[1]
    w = torch.cat([layer.wq, layer.wk, layer.wv, layer.wr], 1)
    b = torch.cat([layer.bq, layer.bk, layer.bv, layer.br])
    p = matmul(h_in, w).add_(b)  # [q | k | v | r]
    out, r = dot_attention_tiled(att, p, heads, d, attn_dropout=attn_dropout, seed=seed)
    wg = layer.wg[:, 0]
    gate = torch.sigmoid(out @ (wg[:d] + wg[2 * d:]) + r @ (wg[d:2 * d] - wg[2 * d:]))
    mix = out + gate[:, None] * (r - out)
    return F.relu(F.layer_norm(mix, (d,), layer.ln_w, layer.ln_b, LN_EPS), inplace=True)


class GraphTransformerNet(nn.Module):
    """Config + operands (``arrays``) + parameters, on one device; the
    surface of :class:`~graphconvgeo_torch.models.gat.GraphAttentionNet`."""

    def __init__(self, cfg: TransformerConfig, x: SparseGraph, adj: SparseGraph, *, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.x = x
        self.adj = adj
        self.device = resolve_device(device)
        arrays = {k: to_device(v, self.device) for k, v in input_operands_of(cfg, x).items()}
        # attention reads the adjacency pattern (the normalized csr holds the
        # self-loops)
        with span("operands.attention"):
            arrays["att"] = to_device(TiledAttentionPattern.from_scipy(adj.csr), self.device)
        self.arrays = arrays
        init_transformer_params(self, cfg, torch.Generator().manual_seed(seed))
        self.to(device=self.device, dtype=torch_dtype(cfg.dtype))

    def hidden_states(self, *, train: bool = False, x_seed: int = 0,
                      generator: Optional[torch.Generator] = None, with_logits: bool = True
                      ) -> list:
        """All per-layer activations. At train time ``x_seed`` keys the
        sparse-input dropout hash and (through :func:`attn_layer_seed`) the
        attention dropout; ``generator`` draws the dense dropout masks."""
        cfg = self.cfg
        drop = train and cfg.dropout > 0.0
        if drop and generator is None:
            raise ValueError("generator required when train=True and dropout > 0")
        attn_rate = cfg.attn_dropout if train else 0.0
        with record_function("input_layer"):
            h = sparse_input_layer(
                self.input, self.arrays, n_rows=self.x.shape[0], n_cols=self.x.shape[1],
                dropout_rate=cfg.dropout, activation=torch.relu, train=train, seed=x_seed,
                gather_dtype=None if cfg.gather_dtype is None else torch_dtype(cfg.gather_dtype),
                out_dtype=torch_dtype(cfg.dtype),
            )
        states = [h]
        for i, layer in enumerate(self.layers):
            fn = functools.partial(unimp_layer, self.arrays["att"], layer, heads=cfg.heads,
                                   attn_dropout=attn_rate, seed=attn_layer_seed(x_seed, i))
            with record_function(f"tx_{i}"):
                h_in = dropout(h, rate=cfg.dropout, generator=generator) if drop else h
                h = checkpoint(fn, h_in, use_reentrant=False) if cfg.remat else fn(h_in)
            states.append(h)
        with record_function("output_layer"):
            if drop:
                h = dropout(h, rate=cfg.dropout, generator=generator)
            if not with_logits:
                states.append(h)
                return states
            states.append(matmul(h, self.out.w) + self.out.b)
        return states

    def apply(self, *, train: bool = False, x_seed: int = 0, generator=None):
        """Returns logits [n_nodes, n_classes]."""
        return self.hidden_states(train=train, x_seed=x_seed, generator=generator)[-1]

    def loss(self, y: torch.Tensor, mask: torch.Tensor, *, train: bool = True, x_seed: int = 0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Masked cross-entropy + L2 over the weights; the head streams over
        row blocks above ~1 GB of logits (``ops/ce_stream.py``)."""
        y = y.long()
        kw = dict(train=train, x_seed=x_seed, generator=generator)
        if int(self.x.shape[0]) * self.cfg.n_classes > streamed_rows_threshold():
            h = self.hidden_states(**kw, with_logits=False)[-1]
            num, den = masked_ce_sums(h, self.out.w, self.out.b, y, mask)
            loss = num / torch.clamp(den, min=1.0)
        else:
            logits = self.apply(**kw)
            ce = -F.log_softmax(logits, dim=-1).gather(1, y[:, None])[:, 0]
            mask = mask.to(ce.dtype)
            loss = torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
        if self.cfg.l2 > 0.0:
            loss = loss + self.cfg.l2 * l2_penalty(self)
        return loss


def l2_penalty(model: GraphTransformerNet) -> torch.Tensor:
    """Σ‖W‖² over the weights (``w*``: the projections, the gate, W₀ and
    the head), not the biases or LayerNorm's affine parameters."""
    total = model.input.w.square().sum() + model.out.w.square().sum()
    for layer in model.layers:
        for name, p in layer.named_parameters():
            if name.startswith("w"):
                total = total + p.square().sum()
    return total
