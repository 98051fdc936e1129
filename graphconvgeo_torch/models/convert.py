"""Carry parameters across from the JAX package.

The JAX model keeps its parameters as a pytree
``{"input": {"w", "b"}, "layers": [{"w", "b", "w_t", "b_t"}, ...],
"out": {"w", "b"}}`` with [in, out] weight layouts; :class:`HighwayGCN`
keeps the same names and layouts, so the carry is a rename and a copy.
Takes numpy arrays (convert with ``jax.tree.map(np.asarray, params)``), so
this module never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params_np: dict) -> dict:
    """JAX-layout parameter pytree of numpy arrays -> a state dict for
    :class:`~graphconvgeo_torch.models.gcn.HighwayGCN` (``load_state_dict``)."""
    out = {}
    for group in ("input", "out"):
        for name, arr in params_np[group].items():
            out[f"{group}.{name}"] = torch.from_numpy(np.array(arr, dtype=np.float32))
    for i, layer in enumerate(params_np["layers"]):
        for name, arr in layer.items():
            out[f"layers.{i}.{name}"] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out
