"""Device meshes (twin of the JAX package's ``launch/mesh.py``).

Defined as FUNCTIONS (never module-level constants), so importing this
module starts no process group and touches no device.

``make_local_mesh`` is the mesh of the devices this job has, as
``("data", "model")`` of shape (n, 1): n is the process group's world
size, 1 on the card (several cards are ROADMAP queue 1 item 9d) and on
the CPU unless the caller started a larger ``gloo`` group. With no
process group it starts one of world size 1 and rank 0 from an
in-process ``HashStore``: no ``env://`` (no ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` or ``WORLD_SIZE``), no TCP port. A second call
reuses that group. ``nccl`` backs a ``cuda`` mesh, ``gloo`` a ``cpu``
one. ``local_mesh`` is the same for a ``with`` block, and destroys at
its end the group it started.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from ..device import resolve

LOCAL_AXES = ("data", "model")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _world(device_type: str) -> int:
    """The world size of the process group, started (world 1, rank 0, an
    in-process store) when there is none."""
    backend = BACKENDS[device_type]
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_backend() != backend:
        raise RuntimeError(
            f"a {dist.get_backend()} process group is running; a "
            f"{device_type} mesh needs {backend}")
    return dist.get_world_size()


def make_local_mesh(device: str | torch.device | None = None):
    """The ``DeviceMesh`` (n, 1) named ``("data", "model")`` on
    ``device``'s type (default ``cuda``; asking for it without a card
    raises), n the world size. On the card it is one device, ``cuda:0``:
    another device index raises, and so does a group of several cards
    (ROADMAP queue 1 item 9d)."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve(device)
    if dev.type == "cuda" and dev.index not in (None, 0):
        raise ValueError(f"the local mesh is cuda:0's, not {dev}'s")
    n = _world(dev.type)
    if dev.type == "cuda":
        if n > 1:
            raise NotImplementedError(
                f"a mesh of {n} cards needs the sharded checkpoint and data "
                f"paths (ROADMAP queue 1 item 9d)")
        torch.cuda.set_device(0)     # so that the mesh need not guess it
    return init_device_mesh(dev.type, (n, 1), mesh_dim_names=LOCAL_AXES)


@contextlib.contextmanager
def local_mesh(device: str | torch.device | None = None):
    """``make_local_mesh(device)`` for the block; a process group that it
    started is destroyed at the end (one that was running is kept)."""
    started = not dist.is_initialized()
    mesh = make_local_mesh(device)
    try:
        yield mesh
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda"):
    """16×16 single pod (256 devices) or 2×16×16 two-pod (512 devices) of
    ``device``'s type: ``cuda`` by default, ``cpu`` for the dry run's
    ``fake`` group (``launch/dryrun.py``), which moves no data; raises
    when the process group (or, with none, this process's one card) has
    fewer devices than that."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices, have {have}: the production mesh is one "
            f"process a device across hosts (ROADMAP queue 1 item 9d)")
    return init_device_mesh(device, shape, mesh_dim_names=axes)
