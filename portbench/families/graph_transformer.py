"""The graph transformer family (UniMP: Shi et al., IJCAI 2021; the port's
``graphconvgeo_torch/models/transformer.py :: GraphTransformerNet``): how
the benchmark builds it, starts it from the seed, counts its work and
checks it against ``reference/transformer.py``. A configuration runs it
with ``"family": "graph_transformer"`` on a materialized Â, whose pattern
the layers attend over; ``harness.load_family`` lists what a family file
provides. The operand layout and the reference problem are the GAT
family's (the same input layer and attended pattern). The port is imported
only inside the functions that build or read its objects.
"""

from __future__ import annotations

import dataclasses
import math

from portbench.counts import H100, bound_line
from portbench.families.gat import (  # noqa: F401 (the family API)
    _attention,
    layout_faults,
    program_layout,
    reference_problem,
)
from portbench.reference.gcn import readings  # noqa: F401 (the family API)
from portbench.reference.transformer import Reference

CONTROLS = ("tf32", "bf16attn", "half")


def build(config: dict, inputs, ds, model_fields: dict, seed: int, device):
    """The port's model on the data layer's Â (``ds``), as ``cli.main
    --model transformer`` builds it."""
    from graphconvgeo_torch.models.transformer import GraphTransformerNet, TransformerConfig
    from graphconvgeo_torch.sparse.formats import SparseGraph

    if ds is None:
        raise ValueError("the graph transformer attends over a materialized Â "
                         "(\"adjacency\": \"materialized\")")
    fields = dict(model_fields, hidden=tuple(model_fields["hidden"]))
    cfg = TransformerConfig(n_features=inputs.x.shape[1], n_classes=inputs.n_classes, **fields)
    return GraphTransformerNet(cfg, SparseGraph(csr=ds.x), SparseGraph(csr=ds.adj, symmetric=True),
                               device=device, seed=seed)


def weight_spec(model) -> dict:
    """(name, shape, dtype) of each parameter, in order."""
    return {"params": [(name, tuple(p.shape), p.dtype) for name, p in model.named_parameters()]}


def initial_weights(spec: dict, seed: int, device) -> dict:
    """The benchmark's initial parameters, made on ``device`` from ``seed``
    with one generator, one call a weight: Glorot-uniform weights (the gate's
    [3d, 1] too), LayerNorm weights 1, zero biases."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape, dtype in spec["params"]:
        if len(shape) == 2:
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            w = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
            out[name] = (w * (2.0 * lim) - lim).to(dtype)
        elif name.endswith("ln_w"):
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        else:
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
    return out


def shapes(config: dict, inputs, ds, model) -> dict:
    """The record's shapes beside the harness's: Â's nonzeros (the edges,
    self-loops included), the attention operand's tiles, tiled and rest
    edges, and the heads."""
    return {"adj_nnz": int(ds.adj.nnz), **_attention(model), "heads": model.cfg.heads}


def epoch_flops(config: dict, shapes: dict) -> float:
    """Model operations of one full-graph training epoch, by
    ``counts.epoch_flops``'s convention (a step is the forward plus twice
    the forward, the input layer's backward twice its forward, one predict
    forward; no recompute, no dropout). A layer: the four projections
    (2·n·d·4d), the scores and the aggregation over the edges (2·E·d each)
    and the gate (2·n·2d)."""
    m = config["model"]
    n, c, edges = shapes["n"], shapes["classes"], shapes["adj_nnz"]
    d = m["hidden"][0]
    x_in = 2.0 * shapes["x_nnz"] * d
    fwd = 0.0
    for _ in m["hidden"]:
        fwd += 2.0 * n * d * 4 * d + 2.0 * 2.0 * edges * d + 2.0 * n * 2 * d
    fwd += 2.0 * n * d * c  # the head
    return 3.0 * x_in + 4.0 * fwd


def dot_attn_bound(config: dict, shapes: dict) -> dict:
    """The least time of one forward and one backward application of the
    dot-product attention at the model's width, counted as the GAT family's
    ``attn_bound`` counts (float32, the FFMA peak): each edge's column once
    (by row, and by column for the backward's column sweep) with the
    pointers, each [n, ·] operand read once, each output written once.

    - forward: q, k, v read; out, the row maxima and sums written;
      4·E·d operations (the scores and the aggregation);
    - backward: q, k, v, g, out, the maxima and sums read, c written and
      read; dq, dk, dv written; 8·E·d operations (⟨g_i, v_j⟩, dq, dk and
      dv over the edges)."""
    m = config["model"]
    n, edges, heads = shapes["n"], shapes["adj_nnz"], m["heads"]
    d = m["hidden"][0]
    wide, narrow, pattern = 4 * n * d, 4 * n * heads, 4 * edges + 4 * (n + 1)
    peak = H100["f32_flops"]
    return {"fwd": bound_line(4 * wide + 2 * narrow + pattern, 4 * edges * d, peak),
            "bwd": bound_line(8 * wide + 4 * narrow + 2 * pattern, 8 * edges * d, peak)}


def counts(config: dict, shapes: dict) -> dict:
    """Merged into the traced record: the model operations of an epoch
    (``metrics/mfu.py``) and the attention's least times
    (``metrics/dot_attn_roofline.py``)."""
    return {"epoch_flops": epoch_flops(config, shapes),
            "dot_attn_bound": dot_attn_bound(config, shapes)}


def describe(cell) -> str:
    """The set-up line's words on the built model and the ``dot_attn_edges``
    counter: the edges the attention walked so far (the set-up job's
    applications, each forward and each backward once)."""
    from graphconvgeo_torch.utils import profiling

    att = cell.model.arrays["att"]
    walked = profiling.counters["dot_attn_edges"]
    return (f"attention {type(att).__name__} ({att.n_tiles} tiles with fillers, "
            f"{att.all_edges.nnz} edges walked an application), input "
            f"{type(cell.model.arrays['x']).__name__}, dot_attn_edges {walked} "
            f"({walked / max(cell.traffic['job_epochs'], 1)!r} an epoch of the set-up job)")


# ---- the check ----------------------------------------------------------


def reference_readings(problem, w0: dict, device, steps: int, mode: str = "config",
                       train_rows=None) -> dict:
    """The reference's losses and norms and the layout it worked out
    (``mode``: one of ``reference/transformer.py :: MODES``; ``train_rows``
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
    TF32 off); ``bf16attn``, the attention aggregation's operands rounded to
    bf16; ``half``, a planted fault, half of the training rows left out and
    the mean taken over the rest."""
    import numpy as np

    if kind == "half":
        rows = np.sort(problem.train_rows)
        return reference_readings(problem, w0, device, steps, train_rows=rows[: len(rows) // 2])
    return reference_readings(problem, w0, device, steps, mode=kind)
