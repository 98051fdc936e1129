"""Sampled (mini-batch) Highway-GCN forward (port of
``graphconvgeo_tpu/models/sampled.py``): GraphSAGE-style execution of the
SAME :class:`~graphconvgeo_torch.models.gcn.HighwayGCN` module as the
full-graph model (its ``input``, ``layers[i]`` and ``out`` parameters), so a
model can train sampled and evaluate full-graph, and its checkpoints serve
either way.

The device side is gathers, one segment sum per layer and GEMMs, all plain
PyTorch ops (``ops/scatter_gather.py``):

    h_L   = act( X[nodes_L] W₀ + b₀ )                     # embedding bag
    for l = L-1 .. 0:
        agg   = segment_sum( val ⊙ (h_{l+1} W)[src] → dst )   # sampled Â row
        conv  = act( agg + b )
        gate  = σ( h_{l+1}[:cap_l] W_T + b_T )                # prefix = nodes_l
        h_l   = gate ⊙ conv + (1−gate) ⊙ h_{l+1}[:cap_l]

Reference parity: approximates ``gcnmodel.py :: GCN`` full-graph propagation
with an unbiased sampled estimator of each Â row (values rescaled by
degree/fanout in the sampler).

The input layer is one ``embedding_bag`` (mode "sum", the token values as
per-sample weights) over the deepest node set's ELL rows. The JAX package
gathers W₀'s rows into [cap_L, K_x, H] and contracts them with an einsum; at
batch 512 and fanouts (10, 10), cap_L is 61,952, so that temporary would be
≈ 4.5 GB in float32 at K_x ≈ 60 and H 300. The bag computes the same sums in
another order. ``gather_dtype`` rounds W₀ and the values to that dtype and
widens both back (exact), so the sums run in float32 as JAX's
``preferred_element_type=float32`` product does.

The ELL's padding slots (value 0) point at spread rows of W₀, not all at
row 0 (:func:`spread_slots`), so no gradient row of the bag's backward
gathers a long run of them. The layers carry the full-graph model's
``torch.profiler`` ranges (``input_layer``, ``conv_<i>``,
``output_layer``).

Randomness is explicit: every dropout, the input values' included, draws
from ``generator`` (on the model's device), as the full-graph model's dense
dropout does. JAX draws from its own keys, so the two packages agree at
dropout 0, not mask for mask.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from graphconvgeo_torch.models.gcn import _ACTIVATIONS, l2_penalty, matmul
from graphconvgeo_torch.ops.dropout import dropout
from graphconvgeo_torch.ops.scatter_gather import gather_rows, segment_sum
from graphconvgeo_torch.ops.spmm import _ell_matvec
from graphconvgeo_torch.sparse.formats import CappedEll, EllMatrix


def spread_slots(xi: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Row ids for the zero-valued (padding) slots of the bag's [rows, K]
    index ``xi``: slot j points at row ``j mod n_rows``. ELL pads every row
    with column 0, so at batch 512 (cap_L 61,952, K_x 32) ≈ 660k padding
    slots would all scatter into dW₀'s row 0, one segment that the bag's
    backward sums serially; spread over every row, none is long. A zero
    weight adds an exact zero wherever it points."""
    return torch.arange(xi.numel(), device=xi.device, dtype=xi.dtype).view_as(xi) % n_rows


def _input_bag(model, x_ell, deep: torch.Tensor, *, drop: bool, generator) -> torch.Tensor:
    """X[deep] · W₀ (before the bias) for the deepest node set ``deep``,
    with the capped layout's overflow tail added by ``ov_id``."""
    cfg = model.cfg
    w0 = model.input.w
    x_main = x_ell.main if isinstance(x_ell, CappedEll) else x_ell
    xi = gather_rows(x_main.indices, deep)  # [cap_L, K_x]
    xv = gather_rows(x_main.values, deep)
    xi = torch.where(xv != 0, xi, spread_slots(xi, w0.shape[0]))
    if drop:
        xv = dropout(xv, rate=cfg.dropout, generator=generator)
    # the W₀ rows' dtype: gather_dtype, else W₀'s own; the products are
    # widened to float32 (exact) so the sums run in float32
    wdt = cfg.gather_torch_dtype or w0.dtype
    w0g = w0.to(wdt).float()
    h = F.embedding_bag(xi, w0g, mode="sum", per_sample_weights=xv.to(wdt).float())
    if isinstance(x_ell, CappedEll) and x_ell.ov is not None:
        # overflow-tail contribution: one global [n_ov, H] bag (n_ov is
        # small), routed to the nodes by ov_id (0 = the all-zero row)
        ovv = x_ell.ov.values
        if drop:
            ovv = dropout(ovv, rate=cfg.dropout, generator=generator)
        ov_h = _ell_matvec(x_ell.ov.indices, ovv.to(wdt).float(), w0g)
        h = h + gather_rows(ov_h, gather_rows(x_ell.ov_id, deep))
    return h.to(w0.dtype)


def sampled_forward(
    model,
    x_ell: "CappedEll | EllMatrix",
    batch_dev: dict,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Logits [batch_cap, C] of the batch's target rows. ``model`` is a
    :class:`HighwayGCN` (only its config and parameters are read; it may
    have been built without an adjacency), ``x_ell`` the BoW input on the
    model's device, ``batch_dev`` the output of :func:`batch_to_device`. At
    train time with dropout, ``generator`` (on the model's device) draws the
    masks."""
    cfg = model.cfg
    act = _ACTIVATIONS[cfg.activation]
    drop = train and cfg.dropout > 0.0
    if drop and generator is None:
        raise ValueError("generator required when train=True and dropout > 0")
    nodes = batch_dev["nodes"]
    n_layers = len(model.layers)

    with record_function("input_layer"):
        h = _input_bag(model, x_ell, nodes[n_layers], drop=drop, generator=generator)
        h = act(h + model.input.b)
    for l in range(n_layers - 1, -1, -1):
        i = n_layers - 1 - l
        layer = model.layers[i]
        cap_l = nodes[l].shape[0]
        with record_function(f"conv_{i}"):
            h_in = dropout(h, rate=cfg.dropout, generator=generator) if drop else h
            hw = matmul(h_in, layer.w)
            contrib = batch_dev["edge_val"][l][:, None] * gather_rows(
                hw, batch_dev["edge_src"][l]
            )
            agg = segment_sum(contrib, batch_dev["edge_dst"][l], cap_l)
            conv = act(agg + layer.b)
            if hasattr(layer, "w_t"):
                gate = torch.sigmoid(matmul(h_in[:cap_l], layer.w_t) + layer.b_t)
                h = gate * conv + (1.0 - gate) * h[:cap_l]
            else:
                h = conv
    with record_function("output_layer"):
        if drop:
            h = dropout(h, rate=cfg.dropout, generator=generator)
        return matmul(h, model.out.w) + model.out.b


def sampled_loss(
    model,
    x_ell,
    batch_dev: dict,
    y_batch: torch.Tensor,
    mask: torch.Tensor,
    *,
    train: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Masked mean cross-entropy of the batch's targets (+ L2), as the
    full-graph loss."""
    logits = sampled_forward(model, x_ell, batch_dev, train=train, generator=generator)
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(1, y_batch.long()[:, None])[:, 0]
    mask = mask.to(ce.dtype)
    loss = torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
    if model.cfg.l2 > 0.0:
        loss = loss + model.cfg.l2 * l2_penalty(model)
    return loss


def batch_to_device(batch, device) -> dict:
    """A :class:`~graphconvgeo_torch.data.sampling.SampledBatch`'s arrays as
    tensors on ``device``: int64 node ids and edge slots, float32 masks and
    values. To a CUDA device the arrays go through pinned host memory
    without a synchronize, so the host can queue the step behind the copy."""
    dev = torch.device(device)

    def put(a, dtype):
        t = torch.as_tensor(a, dtype=dtype)
        return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t.to(dev)

    return {
        "nodes": [put(a, torch.int64) for a in batch.nodes],
        "node_mask": [put(a, torch.float32) for a in batch.node_mask],
        "edge_src": [put(a, torch.int64) for a in batch.edge_src],
        "edge_dst": [put(a, torch.int64) for a in batch.edge_dst],
        "edge_val": [put(a, torch.float32) for a in batch.edge_val],
        "target_mask": put(batch.target_mask, torch.float32),
    }
