"""Graph-attention geolocation model (GAT family, ``nn.Module``).

Port of ``graphconvgeo_tpu/models/gat.py``: an extension family over the same
data pipeline, trainer and evaluation as :class:`HighwayGCN`::

    H₀ = act( X · W₀ + b₀ )                        # shared sparse input layer
    for each hidden layer i = 1..L (heads m, per-head width f, out = m·f):
        Z  = Hᵢ₋₁ Wᵢ
        e_jk = LeakyReLU( (Z a_src)_j + (Z a_dst)_k )   per edge (j→k)
        αᵢ = softmax of e over each node's neighbours
        H̃ᵢ = act( concat_heads( Σ_k αᵢ Z_k ) + bᵢ )
        Hᵢ = H̃ᵢ + Hᵢ₋₁   (residual, when the widths match)
    logits = H_L W_out + b_out

The attention operand is ``bucketed`` (degree-bucketed gathers, any graph)
or ``tiled`` (for community-reordered mention graphs: the flash-style
pattern of dense tiles plus a bucketed rest, whose edges the layer's three
sweeps walk as one list by row and one by column). Parameters keep the JAX names —
``input.w/b``, ``layers.<i>.w/b/a_src/a_dst``, ``out.w/b`` — so
:func:`~graphconvgeo_torch.models.convert.params_from_jax` carries them.
The model has :class:`HighwayGCN`'s surface, so ``Trainer`` and
``predict_classes`` take it unchanged. ``cfg.remat`` recomputes each
attention layer in the backward; its attention dropout is keyed by the
layer's integer seed (a fresh generator or the position hash), so the
recompute draws the same mask, while the dense dropout of its input stays
outside the checkpoint.

Z = H W runs on ``ops/dense.py``'s 3×TF32 kernel on the card from
``dense.MIN_ROWS`` rows (``ops/attention.py :: gat_layer``). The attention
operand's build is the span ``operands.attention``; the tiled layer counts
its rest's edges in ``profiling.counters["attn_rest_edges"]``. At
Twitter-World size (1.4M users, hidden 900-900, 4 heads) a remat step fits
one H100 (its peak: PERF.md §5): the state a step keeps is H₀, each layer's
input and its dropped copy, the head's dropped input and three dropout
masks (≈ 30 GB), and one layer's recompute adds ``_TiledGatCore``'s saved
z and out (``ops/attention_tiled.py``). Its sweeps read and write the
model's [rows, H·f] arrays in place, with no padded copy: the forward makes
only out, the backward only dz; they walk the rest's edges with the tiled
ones and nothing is merged. ELU
runs in place on the fresh pre-activation, so autograd keeps its output (H₀
itself in the input layer) instead of a 5 GB input.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from graphconvgeo_torch.models.gcn import (
    Params,
    _glorot,
    check_shared_fields,
    input_operands_of,
    l2_penalty,
    matmul,
    sparse_input_layer,
    torch_dtype,
)
from graphconvgeo_torch.ops.attention import gat_layer
from graphconvgeo_torch.ops.ce_stream import masked_ce_sums, streamed_rows_threshold
from graphconvgeo_torch.ops.dropout import dropout
from graphconvgeo_torch.sparse.attention_tiles import TiledAttentionPattern
from graphconvgeo_torch.sparse.formats import BucketedAttention, SparseGraph, to_device
from graphconvgeo_torch.utils.device import resolve_device
from graphconvgeo_torch.utils.profiling import span

_ACTIVATIONS = {
    # in place on the fresh pre-activation: autograd keeps ELU's output (for
    # the input layer H₀, held anyway) instead of its input (5 GB at World)
    "elu": functools.partial(F.elu, inplace=True),
    "tanh": torch.tanh,
    "relu": torch.relu,
    "none": lambda x: x,
}


@dataclasses.dataclass(frozen=True)
class GATConfig:
    n_features: int
    n_classes: int
    hidden: tuple = (300, 300)  # per-layer output widths (= heads · per-head width)
    heads: int = 4
    dropout: float = 0.5
    attn_dropout: float = 0.0  # dropout on the attention coefficients
    l2: float = 0.0
    activation: str = "elu"
    negative_slope: float = 0.2  # LeakyReLU slope of the edge scores
    residual: bool = True  # skip connection when consecutive widths match
    dtype: str = "float32"  # the parameters' and the input layer's output dtype
    # cast W₀ to this dtype for the input layer's gathers (sums stay float32)
    gather_dtype: Optional[str] = None
    remat: bool = False  # recompute each attention layer in the backward
    # the shared input layer's options (see GCNConfig)
    input_hot_cache: bool = False
    input_backend: str = "auto"
    slab_cols: int = 4096
    slab_dtype: str = "float32"
    slab_byte_budget: int = 2 << 30
    att_backend: str = "bucketed"  # 'bucketed' | 'tiled'

    def __post_init__(self):
        for h in self.hidden:
            if h % self.heads:
                raise ValueError(
                    f"hidden dims must be divisible by heads={self.heads}, got {self.hidden}"
                )
        if self.activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.att_backend not in ("bucketed", "tiled"):
            raise ValueError(f"unknown att_backend {self.att_backend!r}")
        check_shared_fields(self)


def attn_layer_seed(x_seed: int, layer: int) -> int:
    """The attention-dropout seed of hidden layer ``layer`` at one step: a
    fixed mix of the step's integer ``x_seed`` (host integers, no device
    sync), decorrelated from the input-dropout stream and across layers."""
    return ((x_seed ^ 0x5BD1E995) + 0x9E3779B1 * (layer + 1)) & 0x7FFFFFFF


def init_gat_params(module: nn.Module, cfg: GATConfig, gen: torch.Generator) -> None:
    """Register the GAT's parameters on ``module`` (``input``, ``layers``,
    ``out``): Glorot-uniform weights and attention vectors, zero biases (the
    JAX package's init, from a torch generator, in float32). Shared by the
    single-device and the distributed model."""
    module.input = Params(
        w=_glorot((cfg.n_features, cfg.hidden[0]), gen), b=torch.zeros(cfg.hidden[0])
    )
    in_dims = (cfg.hidden[0],) + tuple(cfg.hidden[:-1])
    layers = []
    for d_in, d_out in zip(in_dims, cfg.hidden):
        f = d_out // cfg.heads
        layers.append(Params(
            w=_glorot((d_in, d_out), gen),
            b=torch.zeros(d_out),
            a_src=_glorot((cfg.heads, f), gen),
            a_dst=_glorot((cfg.heads, f), gen),
        ))
    module.layers = nn.ModuleList(layers)
    module.out = Params(
        w=_glorot((cfg.hidden[-1], cfg.n_classes), gen), b=torch.zeros(cfg.n_classes)
    )


class GraphAttentionNet(nn.Module):
    """Config + operands (``arrays``) + parameters, on one device.

    Usage::

        model = GraphAttentionNet(cfg, x_graph, adj_graph, device="cuda", seed=0)
        logits = model.apply(train=False)
        gen = torch.Generator(device=model.device).manual_seed(1)
        loss = model.loss(y, mask, x_seed=123, generator=gen)
    """

    def __init__(
        self, cfg: GATConfig, x: SparseGraph, adj: SparseGraph, *, device=None, seed: int = 0
    ):
        super().__init__()
        self.cfg = cfg
        self.x = x
        self.adj = adj
        self.device = resolve_device(device)
        arrays = {k: to_device(v, self.device) for k, v in input_operands_of(cfg, x).items()}
        # attention reads the adjacency PATTERN (the scores replace Â's
        # values; the normalized csr already holds the self-loops)
        with span("operands.attention"):
            if cfg.att_backend == "tiled":
                att = TiledAttentionPattern.from_scipy(adj.csr)
            else:
                att = BucketedAttention.from_scipy(adj.csr)
            arrays["att"] = to_device(att, self.device)
        self.arrays = arrays
        init_gat_params(self, cfg, torch.Generator().manual_seed(seed))
        self.to(device=self.device, dtype=torch_dtype(cfg.dtype))

    def hidden_states(
        self,
        *,
        train: bool = False,
        x_seed: int = 0,
        generator: Optional[torch.Generator] = None,
        attn_seeds: Optional[Sequence[int]] = None,
        with_logits: bool = True,
    ) -> list:
        """All per-layer activations. At train time ``x_seed`` keys the
        sparse-input dropout hash and (through :func:`attn_layer_seed`, unless
        ``attn_seeds`` gives one integer per layer) the attention dropout;
        ``generator`` draws the dense dropout masks."""
        cfg = self.cfg
        act = _ACTIVATIONS[cfg.activation]
        drop = train and cfg.dropout > 0.0
        if drop and generator is None:
            raise ValueError("generator required when train=True and dropout > 0")
        attn_rate = cfg.attn_dropout if train else 0.0
        if attn_seeds is None:
            attn_seeds = [attn_layer_seed(x_seed, i) for i in range(len(self.layers))]
        elif len(attn_seeds) != len(self.layers):
            raise ValueError(f"attn_seeds needs one seed per layer ({len(self.layers)})")

        def attn_layer(layer, a_seed, h, h_in):
            dt = torch.promote_types(h_in.dtype, layer.w.dtype)
            z = gat_layer(
                self.arrays["att"], h_in.to(dt), layer.w.to(dt), layer.a_src.to(dt),
                layer.a_dst.to(dt),
                negative_slope=cfg.negative_slope, attn_dropout=attn_rate, seed=a_seed,
            )
            out = act(z + layer.b)
            if cfg.residual and out.shape == h.shape:
                out = out + h
            return out

        with record_function("input_layer"):
            h = sparse_input_layer(
                self.input,
                self.arrays,
                n_rows=self.x.shape[0],
                n_cols=self.x.shape[1],
                dropout_rate=cfg.dropout,
                activation=act,
                train=train,
                seed=x_seed,
                gather_dtype=None if cfg.gather_dtype is None else torch_dtype(cfg.gather_dtype),
                out_dtype=torch_dtype(cfg.dtype),
            )
        states = [h]
        for i, (layer, a_seed) in enumerate(zip(self.layers, attn_seeds)):
            with record_function(f"attn_{i}"):
                h_in = dropout(h, rate=cfg.dropout, generator=generator) if drop else h
                if cfg.remat:
                    h = checkpoint(functools.partial(attn_layer, layer, a_seed), h, h_in,
                                   use_reentrant=False)
                else:
                    h = attn_layer(layer, a_seed, h, h_in)
            states.append(h)
        with record_function("output_layer"):
            if drop:
                h = dropout(h, rate=cfg.dropout, generator=generator)
            if not with_logits:
                states.append(h)
                return states
            states.append(matmul(h, self.out.w) + self.out.b)
        return states

    def apply(self, *, train: bool = False, x_seed: int = 0, generator=None, attn_seeds=None):
        """Returns logits [n_nodes, n_classes]."""
        return self.hidden_states(
            train=train, x_seed=x_seed, generator=generator, attn_seeds=attn_seeds
        )[-1]

    def loss(
        self,
        y: torch.Tensor,
        mask: torch.Tensor,
        *,
        train: bool = True,
        x_seed: int = 0,
        generator: Optional[torch.Generator] = None,
        attn_seeds: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """Masked cross-entropy + L2 over w, a_src and a_dst; the head streams
        over row blocks above ~1 GB of logits (``ops/ce_stream.py``)."""
        y = y.long()
        kw = dict(train=train, x_seed=x_seed, generator=generator, attn_seeds=attn_seeds)
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
