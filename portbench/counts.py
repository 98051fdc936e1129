"""The benchmark's yardstick: the card's published peaks and the work a cell
needs, counted from its shapes and its data's nonzeros, never from the
port's operands' padding or layout.

``bound_line`` and the per-product byte counts follow ``chip_smoke.py ::
bound_line``, ``spmm_bound`` and ``factor_bound``: each nonzero once as a
float32 value and an int32 column, the row pointers, the source rows read
once, the output written once; two operations a nonzero and column.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at its 700 W
# power limit (copied from graphconvgeo_torch/utils/profiling.py :: H100)
H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops": 67e12,  # FFMA, outside the tensor cores
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,  # the highest dense rate of any precision these configurations admit
}


def bound_line(n_bytes: float, flops: float, peak: float) -> dict:
    """The least time of ``n_bytes`` of traffic and ``flops`` operations at
    ``peak`` operations a second, and which of the two sets it."""
    bytes_s = n_bytes / H100["hbm_bytes_per_s"]
    ops_s = flops / peak
    return {"bytes": n_bytes, "flops": flops, "bound_s": max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}


def product_bound(nnz: int, n_out: int, n_src: int, f: int, src_itemsize: int,
                  peak: float) -> dict:
    """One sparse product (out[n_out, f] = M[n_out, n_src] · src): each
    nonzero once (8 bytes), the row pointers, the source read once at
    ``src_itemsize`` bytes an entry, the output written once in float32."""
    n_bytes = 8 * nnz + 4 * (n_out + 1) + src_itemsize * f * n_src + 4 * f * n_out
    return bound_line(n_bytes, 2 * nnz * f, peak)


def apply_bound(config: dict, shapes: dict) -> dict:
    """The least time of one Â·H application of the configuration's
    operator at the model's width. Materialized Â: one product over Â's
    nonzeros. Factorized Â: Bᵀ·h over the group memberships, then B·y back
    (the diagonal and the multiplicity corrections are left out, so this is
    a lower bound of the operator). The source is read at the gather dtype
    and the contraction runs at its peak."""
    m = config["model"]
    f = m["hidden"][0]
    bf16 = m.get("gather_dtype") == "bfloat16"
    item = 2 if bf16 else 4
    peak = H100["bf16_flops"] if bf16 else H100["f32_flops"]
    n = shapes["n"]
    if config["adjacency"] == "factorized":
        g, memb = shapes["groups"], shapes["memberships"]
        first = product_bound(memb, g, n, f, item, peak)
        second = product_bound(memb, n, g, f, item, peak)
        parts = [first, second]
    else:
        parts = [product_bound(shapes["adj_nnz"], n, n, f, item, peak)]
    return {"bound_s": sum(p["bound_s"] for p in parts),
            "bytes": sum(p["bytes"] for p in parts), "flops": sum(p["flops"] for p in parts)}


def epoch_flops(config: dict, shapes: dict) -> float:
    """Model operations of one full-graph training epoch: a step (forward
    plus twice the forward for the backward; the input layer's backward
    only dW₀, so twice its forward) and one predict forward. X·W₀ counts
    X's nonzeros; Â·H counts the operator's nonzeros (Â's when
    materialized, twice the group memberships when factorized); no
    recompute and no dropout."""
    m = config["model"]
    hidden = list(m["hidden"])
    n, c = shapes["n"], shapes["classes"]
    x_in = 2.0 * shapes["x_nnz"] * hidden[0]
    if config["adjacency"] == "factorized":
        sparse_nnz = 2 * shapes["memberships"]
    else:
        sparse_nnz = shapes["adj_nnz"]
    fwd = 0.0
    prev = hidden[0]
    for h in hidden:
        fwd += 2.0 * n * prev * h  # H W
        fwd += 2.0 * sparse_nnz * h  # Â (H W)
        if m.get("highway", True) and prev == h:
            fwd += 2.0 * n * prev * h  # the gate's H W_T
        prev = h
    fwd += 2.0 * n * prev * c  # the head
    return 3.0 * x_in + 4.0 * fwd
