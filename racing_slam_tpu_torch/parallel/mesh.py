"""Process groups and device meshes (port of racing_slam_tpu/parallel/mesh.py).

Scale-out has two axes, as in the JAX package: independent sequences
('seq', data parallel, no communication) and landmark shards of bundle
adjustment ('lm', one all-reduce of the reduced camera system an LM
iteration, parallel/dist_ba.py). The JAX package lays a `Mesh` over its
devices and lets XLA insert the collectives; here every rank is one
process with one device, `torch.distributed` carries the collectives
(NCCL between cards, gloo between CPU processes), and a
`torch.distributed.device_mesh.DeviceMesh` names the ranks' grid.

A rank holds its own sequence rows on its one device, and the ranks that
share a 'seq' coordinate (the 'lm' shards of those rows) each hold the
same rows. That replaces the JAX package's `put_sharded`: no array is
assembled across processes, and each rank decodes only its own videos.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device


def _backend(device: torch.device) -> str:
    """NCCL for CUDA tensors (gloo beside it for host objects), gloo for CPU."""
    return "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    store_path: str | None = None,
    device: str | torch.device = "cuda",
    timeout_s: float = 300.0,
) -> int:
    """Join the process group: `torch.distributed.init_process_group` from
    arguments or the environment. Call once per process, before any
    collective. Returns the world size.

    Precedence as the JAX package's (mesh.py:19-50): explicit arguments >
    SLAM_COORDINATOR / SLAM_NUM_PROCESSES / SLAM_PROCESS_ID > a single
    process, which is a no-op returning 1.
    With a coordinator ("host:port") the ranks meet over TCP; without one
    they meet through a FileStore at `store_path`, a file on a file system
    every rank sees (no port to pick, none to collide). A single process
    with a `store_path` joins a world of one. The backend is NCCL for
    `device` "cuda" (the default; raises without a card) and gloo for
    "cpu"; in a world over NCCL each rank uses the card of its local rank."""
    coordinator_address = coordinator_address or os.environ.get("SLAM_COORDINATOR")
    if num_processes is None and "SLAM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SLAM_NUM_PROCESSES"])
    if process_id is None and "SLAM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SLAM_PROCESS_ID"])
    if dist.is_initialized():
        return dist.get_world_size()
    if coordinator_address is None and store_path is None and num_processes in (None, 1):
        return 1  # single process: nothing to initialize
    world = 1 if num_processes is None else num_processes
    rank = 0 if process_id is None else process_id
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if coordinator_address is not None:
        init = dict(init_method=f"tcp://{coordinator_address}")
    else:
        if store_path is None:
            raise ValueError("several processes and no coordinator: give a store_path "
                             "that every rank sees")
        init = dict(store=dist.FileStore(store_path, world))
    dist.init_process_group(_backend(dev), world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s), **init)
    return dist.get_world_size()


def make_mesh(shape: dict[str, int] | None = None, device: str | torch.device = "cuda"
              ) -> DeviceMesh | None:
    """A DeviceMesh of {axis: size} over the ranks of the process group, in
    rank order (the last axis fastest). Default: every rank on 'lm'. Raises
    ValueError when the sizes do not multiply to the world size. A process
    that has joined no group is a single process: its mesh is None (every
    consumer's single-process path), and only sizes that multiply to 1 are
    accepted. `device` is the ranks' device, the card unless told
    otherwise."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = {"lm": world}
    sizes = tuple(shape.values())
    n = 1
    for s in sizes:
        n *= s
    if n != world:
        raise ValueError(f"mesh {shape} needs {n} ranks, have {world}")
    if not dist.is_initialized():
        return None
    return DeviceMesh(dev.type, torch.arange(world).reshape(sizes),
                      mesh_dim_names=tuple(shape.keys()))


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    """Ranks along `axis` (1 with no mesh, or an axis the mesh lacks)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh[axis].size()


def axis_rank(mesh: DeviceMesh | None, axis: str) -> int:
    """This rank's coordinate along `axis` (0 with no mesh or axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh | None, axis: str):
    """The process group along `axis`, or None (no mesh, or no such axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)
