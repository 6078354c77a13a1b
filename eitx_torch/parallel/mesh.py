"""Device meshes over the process group.

Port of eitx/parallel/mesh.py. eitx places one program over all of a
host's devices (``jax.sharding.Mesh``); here every device is driven by
its own process, the processes join one ``torch.distributed`` group, and
a ``DeviceMesh`` names the group's ranks by axis. The default shape puts
every rank on the first axis (``data``) and 1 on the rest, as eitx's.

The card's group runs on NCCL and the CPU's on gloo; a mesh asked for on
one never runs on the other. Nothing reads a cluster's address from the
environment: ``init_distributed`` joins the group through a file that
every process of the run can open.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.device import resolve_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(rank: int, world_size: int, store_path: str,
                     device_type: str = "cuda") -> torch.device:
    """Join this process, as ``rank`` of ``world_size``, to the default
    process group through a ``FileStore`` at ``store_path`` (a file in a
    directory that every process of the run can reach, fresh for each
    run). On the card the process drives device ``rank`` modulo the
    host's device count. Returns the process's device."""
    if device_type not in _BACKEND:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    dev = resolve_device(device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(_BACKEND[device_type], store=store, rank=rank,
                            world_size=world_size)
    return dev


def make_device_mesh(
    axes: Tuple[str, ...] = ("data", "model"),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence[int]] = None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A ``DeviceMesh`` over the initialised group's ranks (or the given
    ``devices``, a list of ranks), ``shape`` over ``axes``.

    Default shape: every rank on the first axis and 1 on the rest. A
    shape whose product is not the number of ranks raises ``ValueError``.
    Every rank of the group calls this together."""
    if device_type not in _BACKEND:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    resolve_device(device_type)  # the card, or raise: no fallback
    if not dist.is_initialized():
        raise RuntimeError(
            "make_device_mesh needs an initialised process group: call "
            "init_distributed(rank, world_size, store_path, device_type) "
            "in every process first")
    backend = dist.get_backend()
    if _BACKEND[device_type] not in backend:
        raise RuntimeError(
            f"a {device_type} mesh needs the {_BACKEND[device_type]} "
            f"backend; the process group runs {backend}")
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    n = len(ranks)
    if shape is None:
        shape = [n] + [1] * (len(axes) - 1)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} does not name the "
                         f"axes {tuple(axes)}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != device count {n}")
    return DeviceMesh(device_type,
                      torch.tensor(ranks, dtype=torch.int64).reshape(
                          tuple(shape)),
                      mesh_dim_names=tuple(axes))
