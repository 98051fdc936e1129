"""The Highway-GCN family (Rahimi et al. 2018; the port's
``graphconvgeo_torch/models/gcn.py :: HighwayGCN``): how the benchmark
builds it, starts it from the seed, counts its work and checks it against
``reference/gcn.py``. A configuration runs it with ``"family":
"highway_gcn"``; ``harness.load_family`` lists what a family file provides.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from portbench.counts import apply_bound, epoch_flops
from portbench.reference.gcn import Problem, Reference, readings

CONTROLS = ("tf32", "fp8", "half")


def build(config: dict, inputs, ds, model_fields: dict, seed: int, device):
    """The port's model on the configuration's operator: Â from the data
    layer's ``ds`` where it is materialized, else factorized from the
    inputs' mention groups."""
    from graphconvgeo_torch.models.gcn import GCNConfig, HighwayGCN
    from graphconvgeo_torch.sparse.formats import SparseGraph

    fields = dict(model_fields, hidden=tuple(model_fields["hidden"]))
    cfg = GCNConfig(n_features=inputs.x.shape[1], n_classes=inputs.n_classes, **fields)
    if config["adjacency"] == "materialized":
        adj_op = SparseGraph(csr=ds.adj, symmetric=True)
    else:
        from graphconvgeo_torch.sparse.factorized import FactorizedAdjacency

        adj_op = FactorizedAdjacency.from_groups(
            dict(enumerate(inputs.groups)), inputs.n,
            direct=(inputs.direct_src, inputs.direct_dst))
    src = ds if ds is not None else inputs
    return HighwayGCN(cfg, SparseGraph(csr=src.x), adj_op, device=device, seed=seed)


def weight_spec(model) -> dict:
    """What :func:`initial_weights` needs once the model is freed: (name,
    shape, dtype) of each parameter, in order, and the highway gates' bias
    (the model's ``gate_bias_init``)."""
    return {"params": [(name, tuple(p.shape), p.dtype) for name, p in model.named_parameters()],
            "gate_bias": float(model.cfg.gate_bias_init)}


def initial_weights(spec: dict, seed: int, device) -> dict:
    """The benchmark's initial parameters, made on ``device`` from ``seed``
    with one generator, one call a weight: Glorot-uniform weights, zero
    biases, the highway gates' bias at the spec's ``gate_bias``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape, dtype in spec["params"]:
        if len(shape) == 2:
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            w = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
            out[name] = (w * (2.0 * lim) - lim).to(dtype)
        elif name.endswith("b_t"):
            out[name] = torch.full(shape, spec["gate_bias"], device=device, dtype=dtype)
        else:
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
    return out


def shapes(config: dict, inputs, ds, model) -> dict:
    """The record's shapes beside the harness's: Â's nonzeros and its dense
    tiles where it is materialized."""
    if ds is None:
        return {"adj_nnz": None}
    return {"adj_nnz": int(ds.adj.nnz), "tiles": _tile_count(model)}


def counts(config: dict, shapes: dict) -> dict:
    """Merged into the traced record: the model operations of an epoch
    (``metrics/mfu.py``) and the least time of one Â·H application
    (``metrics/spmm_roofline.py``)."""
    return {"epoch_flops": epoch_flops(config, shapes),
            "apply_bound": apply_bound(config, shapes)}


def describe(cell) -> str:
    """The set-up line's words on the built model."""
    return (f"backend {cell.model.backend}, input "
            f"{type(cell.model.arrays['x']).__name__}")


def program_layout(model) -> dict:
    """The program's input slab and hot-cache columns and its factorized
    operator's tile counts (None where it has none), which the check holds
    against those the reference works out (``layout_faults``)."""
    from graphconvgeo_torch.sparse.factorized import FactorizedAdjacency
    from graphconvgeo_torch.sparse.formats import SlabbedBell

    out = {"slab_cols": None, "hot_ids": None, "bt_tiles": None, "zr_tiles": None}
    x_op = model.arrays["x"]
    rest = getattr(x_op, "rest", None) if isinstance(x_op, SlabbedBell) else x_op
    if isinstance(x_op, SlabbedBell):
        out["slab_cols"] = np.sort(x_op.cols.cpu().numpy())
    if hasattr(rest, "hot_ids"):
        out["hot_ids"] = np.sort(rest.hot_ids.cpu().numpy())
    adj = model.arrays.get("adj")
    if isinstance(adj, FactorizedAdjacency):
        for name in ("bt", "zr"):
            tiles = getattr(adj, f"{name}_tiles")
            out[f"{name}_tiles"] = 0 if tiles is None else int(tiles.n_tiles)
    return out


def layout_faults(program: dict, reference: dict) -> int:
    """Parts of the program's operand layout that differ from what the
    reference worked out from the configuration's rules."""
    bad = 0
    for key in ("slab_cols", "hot_ids"):
        a, b = program[key], reference[key]
        bad += (a is None) != (b is None) or (a is not None and not np.array_equal(a, b))
    for key in ("bt_tiles", "zr_tiles"):
        if reference[key] is not None:
            bad += program[key] != reference[key]
    return int(bad)


def _tile_count(model) -> int:
    """Dense tiles of the model's Â operand (0 without tiles), for the
    record."""
    adj = model.arrays.get("adj")
    tiles = adj[0] if isinstance(adj, tuple) else adj
    return int(getattr(tiles, "n_tiles", 0) or 0)


# ---- the check ----------------------------------------------------------


def reference_problem(cell):
    """The reference's problem in the program's node order: the benchmark's
    inputs relabeled by the port's reordering (the one piece of the
    program's state it follows), with the configuration's model fields and
    layout rules."""
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
        slab_bf16=m.get("slab_dtype") == "bfloat16",
        factorized=cell.config["adjacency"] == "factorized", model=dict(m),
        layout=cell.config["layout"])


def reference_readings(problem, w0: dict, device, steps: int, mode: str = "config",
                       train_rows=None) -> dict:
    """The reference's losses and norms and the layout it worked out
    (``mode``: its precision; ``train_rows`` replaces the problem's training
    rows, a planted fault)."""
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
    ``tf32``, the GEMMs in TF32 (the configuration states float32, TF32
    off); ``fp8``, the stated bf16 roundings in e4m3; ``half``, a planted
    fault, half of the training rows left out and the mean taken over the
    rest."""
    if kind == "half":
        rows = np.sort(problem.train_rows)
        return reference_readings(problem, w0, device, steps, train_rows=rows[: len(rows) // 2])
    return reference_readings(problem, w0, device, steps, mode=kind)
