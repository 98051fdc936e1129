"""The GAT family (Veličković et al., ICLR 2018; the port's
``graphconvgeo_torch/models/gat.py :: GraphAttentionNet``): how the
benchmark builds it, starts it from the seed, counts its work and checks it
against ``reference/gat.py``. A configuration runs it with ``"family":
"gat"`` on a materialized Â, whose pattern the layers attend over;
``harness.load_family`` lists what a family file provides. The port is
imported only inside the functions that build or read its objects, as the
harness imports it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from portbench.counts import H100, bound_line
from portbench.reference.gat import Reference
from portbench.reference.gcn import Problem, readings

CONTROLS = ("tf32", "bf16attn", "half")


def build(config: dict, inputs, ds, model_fields: dict, seed: int, device):
    """The port's model on the data layer's Â (``ds``), as ``cli.main
    --model gat`` builds it."""
    from graphconvgeo_torch.models.gat import GATConfig, GraphAttentionNet
    from graphconvgeo_torch.sparse.formats import SparseGraph

    if ds is None:
        raise ValueError("the GAT attends over a materialized Â (\"adjacency\": \"materialized\")")
    fields = dict(model_fields, hidden=tuple(model_fields["hidden"]))
    cfg = GATConfig(n_features=inputs.x.shape[1], n_classes=inputs.n_classes, **fields)
    return GraphAttentionNet(cfg, SparseGraph(csr=ds.x), SparseGraph(csr=ds.adj, symmetric=True),
                             device=device, seed=seed)


def weight_spec(model) -> dict:
    """(name, shape, dtype) of each parameter, in order."""
    return {"params": [(name, tuple(p.shape), p.dtype) for name, p in model.named_parameters()]}


def initial_weights(spec: dict, seed: int, device) -> dict:
    """The benchmark's initial parameters, made on ``device`` from ``seed``
    with one generator, one call a weight: Glorot-uniform weights and
    attention vectors, zero biases."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape, dtype in spec["params"]:
        if len(shape) == 2:
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            w = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
            out[name] = (w * (2.0 * lim) - lim).to(dtype)
        else:
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
    return out


def _attention(model) -> dict:
    """The attention operand's tiles that hold edges (filler tiles hold
    none), tiled edges and rest edges."""
    import torch

    att = model.arrays["att"]
    tiles = int(torch.count_nonzero(att.mask_bits.reshape(att.n_tiles, -1).ne(0).any(1)))
    return {"tiles": tiles, "tiled_edges": int(att.stats()["tiled_edges"]),
            "rest_edges": att.rest_nnz}


def shapes(config: dict, inputs, ds, model) -> dict:
    """The record's shapes beside the harness's: Â's nonzeros (the edges,
    self-loops included), the attention operand's tiles, tiled and rest
    edges, and the heads."""
    return {"adj_nnz": int(ds.adj.nnz), **_attention(model), "heads": model.cfg.heads}


def epoch_flops(config: dict, shapes: dict) -> float:
    """Model operations of one full-graph training epoch, by
    ``counts.epoch_flops``'s convention (a step is the forward plus twice
    the forward, the input layer's backward twice its forward, one predict
    forward; no recompute, no dropout). A layer: Z = H W, the aggregation
    over the edges (2·E·width) and the score vectors s and d (2·n·width
    each)."""
    m = config["model"]
    n, c, edges = shapes["n"], shapes["classes"], shapes["adj_nnz"]
    hidden = list(m["hidden"])
    x_in = 2.0 * shapes["x_nnz"] * hidden[0]
    fwd, prev = 0.0, hidden[0]
    for h in hidden:
        fwd += 2.0 * n * prev * h + 2.0 * edges * h + 2.0 * 2.0 * n * h
        prev = h
    fwd += 2.0 * n * prev * c  # the head
    return 3.0 * x_in + 4.0 * fwd


def attn_bound(config: dict, shapes: dict) -> dict:
    """The least time of one forward and one backward application of the
    tiled layer at the model's width, counted as ``counts.py`` counts a
    product (float32, the FFMA peak): each edge's column once (by row, and
    by column for the backward's column sweep) with the row pointers, each
    [n, ·] operand read once, each output written once.

    - forward: Z, s, d read; out, the row maxima and sums written;
      2·E·width operations (the aggregation);
    - backward: Z, g, out, s, d, the maxima and sums and c = ⟨g, out⟩
      read; dZ, ds, dd written; 4·E·width operations (g·Zᵀ over the
      edges and (κα)ᵀ·g)."""
    m = config["model"]
    n, edges, heads = shapes["n"], shapes["adj_nnz"], m["heads"]
    width = m["hidden"][0]
    wide, narrow, pattern = 4 * n * width, 4 * n * heads, 4 * edges + 4 * (n + 1)
    peak = H100["f32_flops"]
    return {"fwd": bound_line(2 * wide + 4 * narrow + pattern, 2 * edges * width, peak),
            "bwd": bound_line(4 * wide + 7 * narrow + 2 * pattern, 4 * edges * width, peak)}


def counts(config: dict, shapes: dict) -> dict:
    """Merged into the traced record: the model operations of an epoch
    (``metrics/mfu.py``) and the tiled layer's least times
    (``metrics/attn_roofline.py``)."""
    return {"epoch_flops": epoch_flops(config, shapes), "attn_bound": attn_bound(config, shapes)}


def describe(cell) -> str:
    """The set-up line's words on the built model."""
    att = cell.model.arrays["att"]
    return (f"attention {type(att).__name__} ({att.n_tiles} tiles with fillers), input "
            f"{type(cell.model.arrays['x']).__name__}")


def program_layout(model) -> dict:
    """The program's input slab and hot-cache columns, its attention tiles
    and rest edges, which the check holds against those the reference works
    out (``layout_faults``)."""
    from graphconvgeo_torch.sparse.formats import SlabbedBell

    out = {"slab_cols": None, "hot_ids": None}
    x_op = model.arrays["x"]
    rest = getattr(x_op, "rest", None) if isinstance(x_op, SlabbedBell) else x_op
    if isinstance(x_op, SlabbedBell):
        out["slab_cols"] = np.sort(x_op.cols.cpu().numpy())
    if hasattr(rest, "hot_ids"):
        out["hot_ids"] = np.sort(rest.hot_ids.cpu().numpy())
    att = _attention(model)
    return {**out, "att_tiles": att["tiles"], "att_rest_edges": att["rest_edges"]}


def layout_faults(program: dict, reference: dict) -> int:
    """Parts of the program's operand layout that differ from what the
    reference worked out from the configuration's rules."""
    bad = 0
    for key in ("slab_cols", "hot_ids"):
        a, b = program[key], reference[key]
        bad += (a is None) != (b is None) or (a is not None and not np.array_equal(a, b))
    return int(bad + sum(program[k] != reference[k] for k in ("att_tiles", "att_rest_edges")))


# ---- the check ----------------------------------------------------------


def reference_problem(cell):
    """The reference's problem in the program's node order (the one piece
    of the program's state it follows), with the configuration's model
    fields and layout rules."""
    inp, perm = cell.inputs, cell.perm
    n = inp.n
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    m = cell.model_fields
    return Problem(
        x=inp.x[perm].tocsr(), groups=[np.sort(inv[g]) for g in inp.groups],
        direct=(inv[inp.direct_src], inv[inp.direct_dst]), y=np.asarray(inp.y)[perm],
        train_rows=inv[np.asarray(inp.train_idx)], hidden=tuple(m["hidden"]),
        dropout=float(m["dropout"]), lr=float(cell.config["lr"]), seed=cell.seed,
        gather_bf16=m.get("gather_dtype") == "bfloat16",
        slab_bf16=m.get("slab_dtype") == "bfloat16", model=dict(m),
        layout=cell.config["layout"])


def reference_readings(problem, w0: dict, device, steps: int, mode: str = "config",
                       train_rows=None) -> dict:
    """The reference's losses and norms and the layout it worked out
    (``mode``: one of ``reference/gat.py :: MODES``; ``train_rows``
    replaces the problem's training rows, a planted fault)."""
    if train_rows is not None:
        problem = dataclasses.replace(problem, train_rows=train_rows)
    reference = Reference(problem, device, mode=mode)
    out = reference.run(w0, steps=steps)
    out["layout"] = reference.layout()
    return out


def check_numbers(cell, prog: dict, ref: dict) -> dict:
    """The numbers that ``correct`` compares: the readings of the program
    against the reference, and the program's operand layout against the one
    the reference worked out from the configuration (``layout_faults``)."""
    return {**readings(prog, ref), "layout_faults": layout_faults(cell.layout, ref["layout"])}


def control(kind: str, problem, w0: dict, device, steps: int) -> dict:
    """The reference put in the program's place as one of ``CONTROLS``:
    ``tf32``, the dense products in TF32 (the configuration states float32,
    TF32 off); ``bf16attn``, the aggregation's operands rounded to bf16, as
    kernels 3–5′ round them; ``half``, a planted fault, half of the
    training rows left out and the mean taken over the rest."""
    if kind == "half":
        rows = np.sort(problem.train_rows)
        return reference_readings(problem, w0, device, steps, train_rows=rows[: len(rows) // 2])
    return reference_readings(problem, w0, device, steps, mode=kind)
