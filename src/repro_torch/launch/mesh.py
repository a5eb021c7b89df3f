"""Meshes: the production layouts and the host mesh (the reference's
``launch/mesh.py``).  Importing this module touches no device and starts
no process group.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions: ``data`` (data parallel, and ZeRO-1 for the optimizer's
moments), ``model`` (tensor parallel) and, across pods, ``pod``.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# the collective backend each device type needs
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def production_mesh_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``(shape, axis names)``: one pod is 256 chips as (data=16, model=16);
    two pods are 512 as (pod=2, data=16, model=16), the ``pod`` axis pure
    data parallel."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh over an initialised process group of 256 ranks
    (512 with ``multi_pod``), one card each; raises on any other world
    size."""
    shape, axes = production_mesh_shape(multi_pod)
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def _backend(device: str) -> str:
    if device not in BACKENDS:
        raise ValueError(f"no collective backend for device {device!r}; have {sorted(BACKENDS)}")
    return BACKENDS[device]


def make_host_mesh(data: int = 1, model: int = 1, device: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the ranks of the default process group.

    With no process group yet (no launcher started one), this one process
    starts a single-rank group, NCCL on ``cuda`` and gloo on ``cpu``, with
    a ``FileStore`` in a fresh temporary directory.  A group that exists
    must use the device's backend: on ``cuda`` it is NCCL or this raises.
    ``data * model`` must equal the group's world size."""
    backend = _backend(device)
    if not dist.is_initialized():
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("make_host_mesh: no CUDA device for an NCCL group")
            torch.cuda.set_device(torch.cuda.current_device())  # this rank's card, chosen
        store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="host_mesh_"), "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"make_host_mesh: the process group runs {dist.get_backend()}, "
                           f"and a {device} mesh needs {backend}")
    if data * model != dist.get_world_size():
        raise ValueError(f"make_host_mesh: data {data} x model {model} != world size "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device, (data, model), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def host_mesh(data: int = 1, model: int = 1, device: str = "cuda") -> Iterator[DeviceMesh]:
    """``make_host_mesh`` for a ``with`` block: a process group it had to
    start is destroyed when the block ends, one that existed is left."""
    started = not dist.is_initialized()
    try:
        yield make_host_mesh(data, model, device)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
