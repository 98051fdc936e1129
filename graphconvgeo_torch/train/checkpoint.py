"""Checkpoint and resume on ``torch.save`` (port of
``graphconvgeo_tpu/train/checkpoint.py``, which uses orbax).

A checkpoint is one file ``step_<step:08d>`` in a directory, holding
``{"params": state dict}`` and optionally ``"opt_state"`` (an optimizer's
``state_dict()``); ``metrics_<step:08d>.json`` may sit beside it. Each file
is written under a temporary name and moved into place with
``os.replace``, so a reader never sees a half-written checkpoint, and
:func:`latest_checkpoint` selects only exact ``step_<digits>`` names, so a
left-over temporary file is never picked. Restoring uses
``torch.load(weights_only=True)``: tensors and plain containers only.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch


def _replace_into(path: str, write) -> None:
    """``write(tmp)`` to a temporary name beside ``path``, then move it
    into place atomically."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(
    directory: str,
    params: dict,
    *,
    opt_state: Optional[dict] = None,
    step: int = 0,
    metrics: Optional[dict] = None,
) -> str:
    """Save ``params`` (a state dict) and, if given, ``opt_state`` as step
    ``step`` under ``directory``; ``metrics`` (nested dicts of numbers) go
    to ``metrics_<step>.json``. Returns the checkpoint's path."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}")
    payload = {"params": {k: v.detach().cpu() for k, v in params.items()}}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    _replace_into(path, lambda tmp: torch.save(payload, tmp))
    if metrics is not None:
        def write(tmp):
            with open(tmp, "w") as f:
                json.dump(_plain(metrics), f)

        _replace_into(os.path.join(directory, f"metrics_{step:08d}.json"), write)
    return path


def _plain(obj):
    """Nested dicts and lists with every number as a Python float."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return float(obj)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The path of the highest ``step_<digits>`` checkpoint under
    ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory) if re.fullmatch(r"step_\d+", d))
    return os.path.join(directory, steps[-1]) if steps else None


def restore_checkpoint(path: str, *, map_location="cpu") -> dict:
    """The saved payload: ``{"params": state dict}`` and, where saved,
    ``"opt_state"``; tensors land on ``map_location``."""
    return torch.load(path, map_location=map_location, weights_only=True)
