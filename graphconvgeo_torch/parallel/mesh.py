"""The graph mesh: one rank's view of a ``torch.distributed`` process group.

The graph workload's scaling axis is the node / edge partition, so the mesh
is 1-D (axis name ``"graph"``): rank r of a world of D owns rows
``[r·rpd, (r+1)·rpd)`` of the padded adjacency and features. JAX's
``Mesh`` of devices becomes a process group with one rank per device: NCCL
on ``cuda:LOCAL_RANK`` (NCCL takes one device per rank), gloo on the CPU.

:func:`init_process_group` sets up the default group from a launcher's
environment (torchrun sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``); without one it is a world of 1 on an
in-process store. A caller that set up its own group (spawned test ranks)
keeps it. A world above 1 is never made up: without a launcher it raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from graphconvgeo_torch.utils.device import resolve_device

GRAPH_AXIS = "graph"
LAUNCHER_ENV = ("RANK", "WORLD_SIZE")


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_process_group(device) -> None:
    """Initialize the default process group for ``device`` (NCCL for
    ``cuda``, gloo for ``cpu``) unless one exists: from torchrun's
    environment, else as a world of 1 on an in-process store. On ``cuda``
    the rank's device is ``cuda:LOCAL_RANK``."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    kw = {}
    if device.type == "cuda":
        kw["device_id"] = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(kw["device_id"])
    if all(k in os.environ for k in LAUNCHER_ENV):
        dist.init_process_group(_backend_for(device), init_method="env://", **kw)
    else:
        dist.init_process_group(_backend_for(device), store=dist.HashStore(), rank=0,
                                world_size=1, **kw)


@dataclasses.dataclass(frozen=True)
class GraphMesh:
    """One rank of the 1-D graph mesh: its process group (None for the
    default group), its rank in that group, the group's size and the
    rank's device."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world_size: int
    device: torch.device

    def global_rank(self, group_rank: int) -> int:
        """The default group's rank of this group's rank ``group_rank`` (what
        point-to-point operations address)."""
        if self.group is None:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)


def make_graph_mesh(device=None, *, n_devices: Optional[int] = None, group=None) -> GraphMesh:
    """The mesh of this rank over ``group`` (default: the default process
    group, set up by :func:`init_process_group` if needed) on ``device``
    (default ``cuda``; raises without CUDA).

    ``n_devices``, when given, must be the group's size. Asking for more
    than one rank without a launcher raises: start one process per device
    with ``torchrun --nproc-per-node N``. The group's backend must be the
    device's (NCCL on ``cuda``, gloo on ``cpu``): gloo never stands in for
    NCCL on the card."""
    device = resolve_device(device)
    launched = all(k in os.environ for k in LAUNCHER_ENV)
    if group is None and n_devices not in (None, 1) and not (launched or dist.is_initialized()):
        raise RuntimeError(
            f"{n_devices} ranks were asked for, but no launcher started this process: run "
            f"torchrun --nproc-per-node {n_devices} ... (one process per device)"
        )
    if group is None:
        init_process_group(device)
    backend = dist.get_backend(group)
    if backend != _backend_for(device):
        raise RuntimeError(f"the process group runs {backend}; {device.type} needs "
                           f"{_backend_for(device)}")
    world = dist.get_world_size(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"{n_devices} devices were asked for, but the process group has "
                         f"{world} ranks (start one process per device)")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return GraphMesh(group=group, rank=dist.get_rank(group), world_size=world, device=device)


def put_host_cast(arr: np.ndarray, dtype: torch.dtype, mesh: GraphMesh) -> torch.Tensor:
    """Block ``mesh.rank`` of the stacked host array ``arr`` [D, ...], cast
    to ``dtype`` on the host and then moved to the rank's device: only the
    rank's own block crosses, at the target dtype's bytes."""
    block = torch.from_numpy(np.ascontiguousarray(arr[mesh.rank]))
    return block.to(dtype).to(mesh.device)
