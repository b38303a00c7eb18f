"""Mesh construction, as ``repro.launch.mesh`` has it, over
``torch.distributed``.

Functions (never module-level), so importing this module touches no process
group.  Shapes: single pod = (16, 16) = 256 ranks (data x model); multi-pod
= (2, 16, 16) = 512 ranks with the extra leading "pod" axis: data
parallelism spans ("pod", "data"), tensor and expert parallelism "model".
"""

from __future__ import annotations

from typing import Union

import torch
import torch.distributed as dist

from ..kernels import resolve_device


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_production_mesh(*, multi_pod: bool = False, device: Union[str, torch.device] = "cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``, over a job of that many ranks
    whose default process group already exists; any other world size
    raises, naming the size it found."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 1
    for s in shape:
        want *= s
    found = dist.get_world_size() if dist.is_initialized() else 1
    if found != want:
        raise RuntimeError(f"the {'multi-pod' if multi_pod else 'single-pod'} mesh {shape} "
                           f"needs a job of {want} ranks; this one has {found}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=axes)


def make_host_mesh(device: Union[str, torch.device] = "cuda"):
    """The degenerate 1 x 1 ``("data", "model")`` mesh over the local device.
    Without a default process group it starts one of world size 1 over an
    in-memory store: NCCL for ``cuda``, gloo only for ``cpu``.  An existing
    group must be of world size 1 and of that backend: nothing falls back
    from NCCL to gloo."""
    device = resolve_device(device)
    backend = _backend(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError(f"the host mesh is 1 x 1; the process group has "
                           f"{dist.get_world_size()} ranks")
    if dist.get_backend() != backend:
        raise RuntimeError(f"a {device.type} mesh needs the {backend} backend; the default "
                           f"process group runs {dist.get_backend()}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, (1, 1), mesh_dim_names=("data", "model"))
