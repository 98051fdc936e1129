"""Carry parameters across from the JAX package.

The JAX models keep their parameters as a pytree with [in, out] weight
layouts: ``{"input": {"w", "b"}, "layers": [{...}, ...], "out": {"w", "b"}}``
where each layer is ``{"w", "b", "w_t", "b_t"}`` for the Highway-GCN and
``{"w", "b", "a_src", "a_dst"}`` (a_src/a_dst [heads, f]) for the GAT.
:class:`~graphconvgeo_torch.models.gcn.HighwayGCN` and
:class:`~graphconvgeo_torch.models.gat.GraphAttentionNet` keep the same names
and layouts, so the carry is a rename and a copy. Takes numpy arrays
(convert with ``jax.tree.map(np.asarray, params)``), so this module never
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(arr) -> torch.Tensor:
    """A numpy leaf as a tensor of its own dtype; bfloat16 (numpy's
    ``ml_dtypes`` type, which torch cannot take directly) goes through its
    bit pattern, so the values carry across exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_jax(params_np: dict) -> dict:
    """JAX-layout parameter pytree of numpy arrays -> a state dict for the
    matching port model (``load_state_dict``); every leaf is copied by name
    and keeps its dtype (float32, or bfloat16 for ``dtype="bfloat16"``)."""
    out = {}
    for group in ("input", "out"):
        for name, arr in params_np[group].items():
            out[f"{group}.{name}"] = _leaf(arr)
    for i, layer in enumerate(params_np["layers"]):
        for name, arr in layer.items():
            out[f"layers.{i}.{name}"] = _leaf(arr)
    return out
