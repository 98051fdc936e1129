"""Highway-GCN geolocation model (``nn.Module``).

Architecture (reference parity with ``gcnmodel.py :: GCN`` — see SURVEY.md
§3.2 for the layer chain this must match allclose):

    H₀ = act( X · W₀ + b₀ )                      # sparse BoW input layer
    for each hidden layer i = 1..L:
        H̃ᵢ = act( Â · (Hᵢ₋₁ Wᵢ) + bᵢ )           # graph convolution (SpMM)
        Tᵢ = σ( Hᵢ₋₁ W_Tᵢ + b_Tᵢ )               # highway gate (optional)
        Hᵢ = Tᵢ ⊙ H̃ᵢ + (1 − Tᵢ) ⊙ Hᵢ₋₁
    logits = H_L W_out + b_out
    loss   = CE(softmax(logits)[idx], y[idx]) + l2 · Σ‖W‖²   # masked to train idx

Parameters keep the JAX package's names and [in, out] layouts —
``input.w/b``, ``layers.<i>.w/b/w_t/b_t``, ``out.w/b`` in the state dict —
so JAX parameters load by plain copy (:mod:`graphconvgeo_torch.models.convert`).
The sparse operands live in ``model.arrays`` on the model's device. The
adjacency is a :class:`SparseGraph` (run on ``cfg.spmm_backend``) or a
:class:`~graphconvgeo_torch.sparse.factorized.FactorizedAdjacency` (the
projection kept in factored form, its own transpose).

Randomness is explicit: the sparse-input dropout is a position-keyed hash
driven by an integer ``x_seed`` (bit-exact with the JAX package for the same
integer), and the dense dropouts draw from a ``torch.Generator``.

``cfg.remat`` recomputes each conv layer in the backward
(``torch.utils.checkpoint``); the dense dropout of its input stays outside
the checkpoint, since the recompute could not redraw the same mask from the
trainer's generator. The layers carry ``torch.profiler`` ranges
(``input_layer``, ``conv_<i>``, ``output_layer``), the JAX package's named
scopes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from graphconvgeo_torch.ops import dense
from graphconvgeo_torch.ops.ce_stream import masked_ce_sums, streamed_rows_threshold
from graphconvgeo_torch.ops.dropout import bell_dropout, dropout, slab_dropout
from graphconvgeo_torch.ops.spmm import (
    device_operands,
    resolve_backend,
    spmm_bell,
    spmm_cached_bell,
    spmm_operands,
    spmm_slabbed,
)
from graphconvgeo_torch.sparse.factorized import FactorizedAdjacency
from graphconvgeo_torch.sparse.formats import CachedBell, SlabbedBell, SparseGraph, to_device
from graphconvgeo_torch.utils.device import resolve_device
from graphconvgeo_torch.utils.profiling import span

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "none": lambda x: x,
}


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    n_features: int
    n_classes: int
    hidden: tuple = (300, 300)
    highway: bool = True
    dropout: float = 0.5
    l2: float = 0.0
    activation: str = "tanh"
    # gate bias init; negative = carry-biased, like the reference highway init
    gate_bias_init: float = -1.0
    spmm_backend: str = "auto"
    # the parameters' dtype and the input layer's output dtype; a float32
    # operand meeting bf16 weights is multiplied in float32, as JAX promotes
    dtype: str = "float32"
    # cast H to this dtype ("bfloat16" or "float32") for the SpMM row
    # gathers and the input layer's W₀; sums stay float32. On the factorized
    # adjacency it also sets the tiles' contraction.
    gather_dtype: Optional[str] = None
    # recompute each conv layer in the backward instead of keeping its
    # activations (one more forward SpMM per layer)
    remat: bool = False
    # hot-column cache for the BoW input SpMM: the frequent tokens' W₀ rows
    # gather from a compact table (CachedBell); off by default, as in JAX
    input_hot_cache: bool = False
    # input layer X·W₀: "slab" = the Zipf-head dense slab (SlabbedBell) when
    # the matrix qualifies, "bell" = gathers only, "auto" = slab when
    # SlabbedBell.from_scipy's size and coverage gate admits it
    input_backend: str = "auto"
    slab_cols: int = 4096
    # the slab's storage dtype: float32 by default, so "auto" never changes
    # the input numerics; bfloat16 halves its bytes (the Twitter presets)
    slab_dtype: str = "float32"
    slab_byte_budget: int = 2 << 30

    def __post_init__(self):
        if self.highway:
            hs = (self.hidden[0],) + tuple(self.hidden)
            for a, b in zip(hs[1:-1], hs[2:]):
                if a != b:
                    raise ValueError(
                        "highway gating needs equal consecutive hidden sizes, got "
                        f"{self.hidden}"
                    )
        if self.activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")
        check_shared_fields(self)

    @property
    def gather_torch_dtype(self) -> Optional[torch.dtype]:
        return None if self.gather_dtype is None else getattr(torch, self.gather_dtype)


def check_shared_fields(cfg) -> None:
    """Validate the dtype and input-layer fields that GCNConfig and
    GATConfig share."""
    if cfg.gather_dtype not in (None, "bfloat16", "float32"):
        raise ValueError(f"unknown gather_dtype {cfg.gather_dtype!r}")
    if cfg.input_backend not in ("auto", "bell", "slab"):
        raise ValueError(f"unknown input_backend {cfg.input_backend!r}")
    for name in (cfg.dtype, cfg.slab_dtype):
        torch_dtype(name)  # raises on an unknown dtype


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype named ``name`` ("float32", "bfloat16", ...)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"unknown floating dtype {name!r}")
    return dt


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two (JAX's promotion: a float32
    activation against bf16 weights multiplies in float32), on the 3×TF32
    kernel where ``ops/dense.py`` engages it."""
    return dense.matmul(a, b, torch.promote_types(a.dtype, b.dtype))


class Params(nn.Module):
    """A named group of parameters (one JAX pytree node: ``{"w": ..., ...}``)."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))


def _glorot(shape, generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return torch.empty(shape, dtype=torch.float32).uniform_(-limit, limit, generator=generator)


def l2_penalty(model: nn.Module) -> torch.Tensor:
    """Σ‖W‖² over all kernel weights (not biases) — the reference's
    ``lasagne.regularization.regularize_network_params(l2)`` equivalent."""
    total = model.input.w.square().sum() + model.out.w.square().sum()
    for layer in model.layers:
        for name, p in layer.named_parameters():
            if not name.startswith("b"):
                total = total + p.square().sum()
    return total


def init_gcn_params(module: nn.Module, cfg: GCNConfig, gen: torch.Generator) -> None:
    """Register the Highway-GCN's parameters on ``module`` (``input``,
    ``layers``, ``out``): Glorot-uniform weights, zero biases, gate bias
    ``gate_bias_init`` (the JAX package's init, from a torch generator, in
    float32). Shared by the single-device and the distributed model."""
    module.input = Params(
        w=_glorot((cfg.n_features, cfg.hidden[0]), gen), b=torch.zeros(cfg.hidden[0])
    )
    in_dims = (cfg.hidden[0],) + tuple(cfg.hidden[:-1])
    layers = []
    for d_in, d_out in zip(in_dims, cfg.hidden):
        p = {"w": _glorot((d_in, d_out), gen), "b": torch.zeros(d_out)}
        if cfg.highway and d_in == d_out:
            p["w_t"] = _glorot((d_in, d_out), gen)
            p["b_t"] = torch.full((d_out,), cfg.gate_bias_init)
        layers.append(Params(**p))
    module.layers = nn.ModuleList(layers)
    module.out = Params(
        w=_glorot((cfg.hidden[-1], cfg.n_classes), gen), b=torch.zeros(cfg.n_classes)
    )


def build_input_operands(
    x: SparseGraph,
    *,
    input_backend: str = "auto",
    slab_cols: int = 4096,
    slab_dtype: str = "float32",
    slab_byte_budget: int = 2 << 30,
    input_hot_cache: bool = False,
) -> dict:
    """Operands (CPU tensors) for the BoW input matrix, shared by the GCN and
    GAT families: SlabbedBell (Zipf-head dense slab) when the matrix
    qualifies and the backend allows it, else CachedBell (opt-in), else
    bucketed-ELL. Returns ``{"x": op, "x_t": transpose-or-None}``. The
    build is the span ``operands.input``."""
    with span("operands.input"):
        x_op = None
        if input_backend in ("auto", "slab"):
            x_op = SlabbedBell.from_scipy(
                x.csr,
                slab_cols=slab_cols,
                slab_dtype=torch_dtype(slab_dtype),
                byte_budget=slab_byte_budget,
            )
        if x_op is None and input_hot_cache:
            x_op = CachedBell.from_scipy(x.csr)
        if x_op is not None:
            return {"x": x_op, "x_t": None}
        return {"x": x.bell(), "x_t": x.bell_t()}


def input_operands_of(cfg, x: SparseGraph) -> dict:
    """:func:`build_input_operands` with a model config's input fields."""
    return build_input_operands(
        x,
        input_backend=cfg.input_backend,
        slab_cols=cfg.slab_cols,
        slab_dtype=cfg.slab_dtype,
        slab_byte_budget=cfg.slab_byte_budget,
        input_hot_cache=cfg.input_hot_cache,
    )


def _dropped_cached_bell(cb: CachedBell, rate: float, seed: int, n_cols: int) -> CachedBell:
    """Sparse-input dropout over a :class:`CachedBell`. The hot part lives in
    a compact column space; its mask keys by compact entry id on a
    decorrelated seed stream so hot/cold id collisions don't pair up."""
    c_hot = int(cb.hot_ids.shape[0])
    hot_seed = seed ^ 0x3779B97
    return dataclasses.replace(
        cb,
        hot=bell_dropout(cb.hot, rate=rate, seed=hot_seed, n_cols_forward=c_hot, transposed=False),
        hot_t=bell_dropout(cb.hot_t, rate=rate, seed=hot_seed, n_cols_forward=c_hot, transposed=True),
        cold=bell_dropout(cb.cold, rate=rate, seed=seed, n_cols_forward=n_cols, transposed=False),
        cold_t=bell_dropout(cb.cold_t, rate=rate, seed=seed, n_cols_forward=n_cols, transposed=True),
    )


def sparse_input_layer(
    params_in: nn.Module,
    arrays: dict,
    *,
    n_rows: int,
    n_cols: int,
    dropout_rate: float,
    activation,
    train: bool,
    seed: int,
    gather_dtype: Optional[torch.dtype] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """H₀ = act(X W₀ + b₀) with sparse-input dropout at train time.

    Reference: ``gcnmodel.py :: SparseInputDenseLayer`` (+ the sparse input
    dropout layer). The hashed dropout mask is keyed by global entry
    position, so the forward and transpose layouts drop identical entries
    and the backward differentiates the *dropped* operator exactly.
    ``gather_dtype`` casts W₀ before its gathers (the JAX package's cast);
    the product is cast to ``out_dtype`` (the model's dtype) before the
    bias."""
    w0 = params_in.w
    if gather_dtype is not None:
        w0 = w0.to(gather_dtype)
    x_op = arrays["x"]
    drop = train and dropout_rate > 0.0
    if isinstance(x_op, SlabbedBell):
        slab, rest, rest_t = x_op.slab, x_op.rest, x_op.rest_t
        if drop:
            slab = slab_dropout(slab, x_op.cols, rate=dropout_rate, seed=seed, n_cols=n_cols)
            if isinstance(rest, CachedBell):
                rest = _dropped_cached_bell(rest, dropout_rate, seed, n_cols)
            elif rest is not None:
                rest = bell_dropout(
                    rest, rate=dropout_rate, seed=seed, n_cols_forward=n_cols, transposed=False
                )
                rest_t = bell_dropout(
                    rest_t, rate=dropout_rate, seed=seed, n_cols_forward=n_cols, transposed=True
                )
        dropped = dataclasses.replace(x_op, slab=slab, rest=rest, rest_t=rest_t)
        h = spmm_slabbed(dropped, w0)
    elif isinstance(x_op, CachedBell):
        if drop:
            x_op = _dropped_cached_bell(x_op, dropout_rate, seed, n_cols)
        h = spmm_cached_bell(x_op, w0)
    else:
        x_bell, x_bell_t = x_op, arrays["x_t"]
        if drop:
            x_bell = bell_dropout(
                x_bell, rate=dropout_rate, seed=seed, n_cols_forward=n_cols, transposed=False
            )
            x_bell_t = bell_dropout(
                x_bell_t, rate=dropout_rate, seed=seed, n_cols_forward=n_cols, transposed=True
            )
        h = spmm_bell(x_bell, x_bell_t, w0)
    return activation(h[:n_rows].to(out_dtype) + params_in.b)


class HighwayGCN(nn.Module):
    """Config + sparse operands (``arrays``) + parameters, on one device.

    Usage::

        model = HighwayGCN(cfg, x_graph, adj_graph, device="cuda", seed=0)
        logits = model.apply(train=False)
        gen = torch.Generator(device=model.device).manual_seed(1)
        loss = model.loss(y, mask, x_seed=123, generator=gen)
    """

    def __init__(
        self,
        cfg: GCNConfig,
        x: SparseGraph,
        adj: "SparseGraph | FactorizedAdjacency | None",
        *,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        self.cfg = cfg
        self.x = x
        self.adj = adj
        self.device = resolve_device(device)
        arrays = input_operands_of(cfg, x)
        self.backend = None
        if isinstance(adj, FactorizedAdjacency):
            # the factored projection operator is symmetric: its own transpose
            self.backend = "factorized"
            arrays["adj"] = arrays["adj_t"] = adj
        elif adj is not None:
            self.backend = cfg.spmm_backend
            if self.backend == "auto":
                self.backend = resolve_backend(adj)
            arrays["adj"], arrays["adj_t"] = device_operands(adj, self.backend, "cpu")
        # one call, so a symmetric Â (adj_t is adj) stays one operand on the
        # device: one copy of its tiles, one packed form for both directions
        self.arrays = dict(zip(arrays, to_device(tuple(arrays.values()), self.device)))
        init_gcn_params(self, cfg, torch.Generator().manual_seed(seed))
        self.to(device=self.device, dtype=torch_dtype(cfg.dtype))

    # ---- forward --------------------------------------------------------
    def hidden_states(
        self,
        *,
        train: bool = False,
        x_seed: int = 0,
        generator: Optional[torch.Generator] = None,
        with_logits: bool = True,
    ) -> list:
        """All per-layer activations (the allclose parity surface, §3.2).

        At train time with dropout, ``x_seed`` keys the sparse-input dropout
        hash and ``generator`` (on the model's device) draws the dense
        dropout masks. ``with_logits=False`` stops before the output head
        (the last state is then the post-dropout final hidden)."""
        cfg = self.cfg
        act = _ACTIVATIONS[cfg.activation]
        drop = train and cfg.dropout > 0.0
        if drop and generator is None:
            raise ValueError("generator required when train=True and dropout > 0")
        n = self.x.shape[0]
        arrays = self.arrays
        gather_dtype = cfg.gather_torch_dtype

        def conv_layer(layer, h, h_in):
            conv = spmm_operands(
                arrays["adj"], arrays["adj_t"], matmul(h_in, layer.w), n_rows=n,
                gather_dtype=gather_dtype,
            )
            conv = act(conv + layer.b)
            if hasattr(layer, "w_t"):
                gate = torch.sigmoid(matmul(h_in, layer.w_t) + layer.b_t)
                return gate * conv + (1.0 - gate) * h
            return conv

        with record_function("input_layer"):
            h = sparse_input_layer(
                self.input,
                arrays,
                n_rows=n,
                n_cols=self.x.shape[1],
                dropout_rate=cfg.dropout,
                activation=act,
                train=train,
                seed=x_seed,
                gather_dtype=gather_dtype,
                out_dtype=torch_dtype(cfg.dtype),
            )
        states = [h]
        for i, layer in enumerate(self.layers):
            with record_function(f"conv_{i}"):
                h_in = dropout(h, rate=cfg.dropout, generator=generator) if drop else h
                if cfg.remat:
                    h = checkpoint(functools.partial(conv_layer, layer), h, h_in,
                                   use_reentrant=False)
                else:
                    h = conv_layer(layer, h, h_in)
            states.append(h)
        with record_function("output_layer"):
            if drop:
                h = dropout(h, rate=cfg.dropout, generator=generator)
            if not with_logits:
                states.append(h)
                return states
            states.append(matmul(h, self.out.w) + self.out.b)
        return states

    def apply(self, *, train: bool = False, x_seed: int = 0, generator=None) -> torch.Tensor:
        """Returns logits [n_nodes, n_classes]."""
        return self.hidden_states(train=train, x_seed=x_seed, generator=generator)[-1]

    # ---- loss -----------------------------------------------------------
    def loss(
        self,
        y: torch.Tensor,
        mask: torch.Tensor,
        *,
        train: bool = True,
        x_seed: int = 0,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Masked cross-entropy + L2 (reference: ``GCN.build`` loss).

        y: [n_nodes] int labels; mask: [n_nodes] bool/float (train idx set).
        Above ~1 GB of logits (N × C) the head streams over row blocks
        (``ops/ce_stream.py``)."""
        y = y.long()
        if int(self.x.shape[0]) * self.cfg.n_classes > streamed_rows_threshold():
            h = self.hidden_states(
                train=train, x_seed=x_seed, generator=generator, with_logits=False
            )[-1]
            num, den = masked_ce_sums(h, self.out.w, self.out.b, y, mask)
            loss = num / torch.clamp(den, min=1.0)
        else:
            logits = self.apply(train=train, x_seed=x_seed, generator=generator)
            ce = -F.log_softmax(logits, dim=-1).gather(1, y[:, None])[:, 0]
            mask = mask.to(ce.dtype)
            loss = torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
        if self.cfg.l2 > 0.0:
            loss = loss + self.cfg.l2 * l2_penalty(self)
        return loss
