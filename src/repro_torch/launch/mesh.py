"""Mesh construction — the port of the reference's ``launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
device and no process group.

* :func:`make_production_mesh` — 16 × 16 (``data``, ``model``) or 2 × 16
  × 16 (``pod``, ``data``, ``model``) ``DeviceMesh`` over a *fake*
  process group of that world size, in this one process: the
  counterpart of XLA's ``--xla_force_host_platform_device_count``.  Its
  collectives move nothing; the dry-run runs meta tensors on it and
  counts what DTensor would send.
* :func:`make_test_mesh` — a small fake-group mesh for CPU tests.
* :func:`make_device_mesh` — a real mesh over this process's devices:
  1 × 1 (``data``, ``model``) on one card over a world-size-1 NCCL
  group (gloo on the CPU).

A process holds one default process group: a second mesh of another
world size (or backend) tears the first group down, so its meshes are
stale afterwards.
"""
from __future__ import annotations

import socket
from typing import Sequence


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init_group(backend: str, world_size: int) -> None:
    """The default process group: ``backend`` with ``world_size`` ranks,
    this process rank 0 (an existing group of another backend or size is
    destroyed first)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() == backend and \
                dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world_size)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            rank=0, world_size=world_size)


def make_fake_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process
    group of ``prod(shape)`` ranks (device type ``cpu``; the dry-run's
    tensors live on the meta device)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    _init_group("fake", n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes)


def make_test_mesh(shape=(2, 4), axes=("data", "model")):
    """Small fake-group mesh for CPU tests."""
    return make_fake_mesh(shape, axes)


def make_device_mesh(device: str = "cuda", shape=(1, 1),
                     axes=("data", "model")):
    """A real ``DeviceMesh`` over this process alone: NCCL on ``cuda``
    (which must be there: no quiet switch to the CPU), gloo on ``cpu``.
    Only a mesh of one rank is made here (a single-process group)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if n != 1:
        raise ValueError(f"a one-process mesh has one rank, not {shape}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was requested but torch sees "
                               "no CUDA card")
        _init_group("nccl", 1)
    elif device == "cpu":
        _init_group("gloo", 1)
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))
