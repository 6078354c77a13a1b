"""Sharding helpers: data-parallel batches, FSDP parameters, and the
sharded factory tail (segmentation, EIT monitoring, the group solve).

Port of eitx/parallel/shard.py. eitx places arrays on a mesh and lets XLA
partition one program; here each rank runs its own block and the blocks
meet in an explicit all-gather. Frames, slices and subjects are
independent, so the three sharded stages run with no collective until
that gather. Each rank computes its block in calls of the shapes the
single-device path uses, which is why the gathered results equal it.
``labels_block``, ``monitoring_block`` and ``group_solve_block`` compute
one rank's block, so one device can check what a world of several
computes.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _axis(mesh: DeviceMesh, axis: str):
    """(this rank's place on ``axis``, the axis's size)."""
    return (mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def _span(n_items: int, rank: int, size: int):
    """(block size, first index) of rank ``rank``'s block of ``n_items``
    split into ``size`` equal blocks (the last padded)."""
    per = -(-n_items // size)
    return per, rank * per


def _gather(local: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Every rank's equal ``local`` block along ``axis``, concatenated on
    the leading dimension in rank order."""
    size = _axis(mesh, axis)[1]
    out = local.new_empty((size * local.shape[0],) + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(out, local.contiguous(),
                                group=mesh.get_group(axis))
    return out


def shard_batch(x, mesh: DeviceMesh, axis: str = "data"):
    """This rank's block of ``x``'s leading axis over ``axis`` (an array
    stays an array, a tensor a tensor; a view, no copy). Every rank is
    given the same global batch, as eitx's train step is."""
    n = x.shape[0]
    rank, size = _axis(mesh, axis)
    per, start = _span(n, rank, size)
    if n % size:
        raise ValueError(f"a batch of {n} does not split over the {size} "
                         f"ranks of the {axis!r} axis")
    return x[start:start + per]


def fsdp_shard_dim(shape, n: int, min_size: int = 2**14) -> Optional[int]:
    """eitx's rule (shard.py:27-43): the dimension of a parameter of
    ``shape`` that an axis of ``n`` ranks shards, the largest that ``n``
    divides (ties in numpy's argsort order), or None where eitx
    replicates (under ``min_size`` elements, a scalar, nothing divides)."""
    shape = tuple(int(s) for s in shape)
    if not shape or int(np.prod(shape)) < min_size:
        return None
    for d in np.argsort(shape)[::-1]:
        if shape[d] % n == 0:
            return int(d)
    return None


def shard_params_fsdp(model: torch.nn.Module, mesh: DeviceMesh,
                      axis: str = "model", min_size: int = 2**14):
    """Shard ``model``'s parameters over ``axis`` with FSDP2
    (``fully_shard``), replicated over the mesh's other axis (HSDP on a
    (data, model) mesh). A parameter that eitx shards is split on eitx's
    dimension (``fsdp_shard_dim``); FSDP2 splits every other parameter on
    dimension 0 where eitx replicates it, which changes no number: the
    parameters are gathered whole before they are used. Returns the
    module, now an ``FSDPModule`` whose parameters are DTensors."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    names = mesh.mesh_dim_names
    if axis != names[-1]:
        raise ValueError(f"the sharded axis {axis!r} must be the mesh's "
                         f"last axis (axes {names})")
    if len(names) > 2:
        raise ValueError(f"FSDP2 takes a mesh of 1 or 2 axes, got {names}")
    n = mesh.size(len(names) - 1)

    def place(p):
        d = fsdp_shard_dim(p.shape, n, min_size)
        return Shard(0 if d is None else d)

    return fully_shard(model, mesh=mesh, shard_placement_fn=place)


def _padded_block(x, rank: int, size: int):
    """Rank ``rank``'s block of ``x`` (a list, an array or a tensor; its
    leading axis) split into ``size`` equal blocks, ``x`` padded at the
    end by repeating its last item."""
    per, start = _span(len(x), rank, size)
    block = x[start:start + per]
    short = per - len(block)
    if short == 0:
        return block
    if isinstance(x, list):
        return block + [x[-1]] * short
    if isinstance(x, np.ndarray):
        return np.concatenate([block, np.repeat(x[-1:], short, axis=0)])
    return torch.cat([block, x[-1:].expand(short, *x.shape[1:])])


def labels_block(runner, images: np.ndarray, rank: int, size: int,
                 chunk: int = 16) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s block of ``sharded_segment_labels``:
    the coarse label canvases of its ceil(B / size) uint8 images, in calls of
    the single-device path's shape (``min(B, chunk)`` images, the block
    padded by repeating its last image): the card's convolution
    algorithms are chosen by batch size, and another shape may move a
    label at the threshold."""
    b = images.shape[0]
    call = min(b, chunk)
    local = _padded_block(images, rank, size)
    per = local.shape[0]
    local = np.concatenate(
        [local, np.repeat(local[-1:], (-per) % call, axis=0)])
    with torch.inference_mode():
        return torch.cat([
            runner._segment_labels_device(
                torch.from_numpy(np.ascontiguousarray(
                    local[k:k + call])).to(runner.device), False)
            for k in range(0, local.shape[0], call)])[:per]


def sharded_segment_labels(runner, images: np.ndarray,
                           mesh: Optional[DeviceMesh] = None,
                           chunk: int = 16) -> np.ndarray:
    """Data-parallel tissue segmentation: ``runner.segment_labels`` with
    the slices split over ``data``.

    Each rank runs the segmenter's device program on its block of the
    batch (``labels_block``), the ranks all-gather the coarse label
    canvases, and every rank un-letterboxes and upsamples them as the
    single-device path does. Weights are every rank's own copy. A rank
    runs whole calls of the single path's size, so the ranks divide the
    work once the batch is at least ``chunk`` images a rank."""
    from .mesh import make_device_mesh

    if mesh is None:
        mesh = make_device_mesh(("data",), device_type=runner.device.type)
    arr = np.asarray(images)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    b, h, w = arr.shape[0], arr.shape[1], arr.shape[2]
    with torch.inference_mode():
        coarse = _gather(labels_block(runner, arr, *_axis(mesh, "data"),
                                      chunk=chunk), mesh, "data")[:b]
    out = np.empty((b, h, w), np.int32)
    runner._upsample_labels_into(out, coarse.cpu().numpy(), q=4)
    return out


def monitoring_block(cs, sigma, el_pos, ex_mat, meas_mat, rank: int,
                     size: int) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s block of ``sharded_eit_monitoring``:
    the voltages of its ceil(T / size) frames (the run's frames padded by
    repeating the last), solved in the stacks the single-device call
    solves all T frames in (``solve_stack_frames``). A frame's voltages
    depend on its stack's size alone, so they equal the single call's."""
    from ..fem.solver import (
        _values,
        solve_frames_in_stacks,
        solve_stack_frames,
    )

    sigma = _values(sigma, cs.k_class.dtype, cs.k_class.device)
    return solve_frames_in_stacks(
        cs, _padded_block(sigma, rank, size), el_pos, ex_mat, meas_mat,
        solve_stack_frames(cs, sigma.shape[0]))


def sharded_eit_monitoring(cs, sigma, el_pos, ex_mat, meas_mat,
                           mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """``forward_solve_batched`` with the (T, C) frames split over
    ``data``: every rank holds ``cs`` whole (K_class and diag_fix are the
    same on every rank), solves its block of frames (``monitoring_block``)
    and the ranks all-gather. Returns (T, n_exc, n_meas) on ``cs``'s
    device, equal to the single call's. A rank solves whole stacks of the
    single call's size, so the ranks divide the work where the run's
    frames fill several stacks (an lc-7 thorax: more than 113 frames)."""
    from .mesh import make_device_mesh

    if mesh is None:
        mesh = make_device_mesh(("data",),
                                device_type=cs.k_class.device.type)
    v = monitoring_block(cs, sigma, el_pos, ex_mat, meas_mat,
                         *_axis(mesh, "data"))
    return _gather(v, mesh, "data")[:len(sigma)]


def group_solve_block(solvers, lung_alphas, rank: int,
                      size: int) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s block of ``sharded_group_solve``: each
    of its subjects' own ``solve`` (the subject list padded by repeating
    the last), stacked."""
    return torch.stack([s.solve(lung_alphas)
                        for s in _padded_block(list(solvers), rank, size)])


def sharded_group_solve(solvers, lung_alphas, mesh: DeviceMesh,
                        axis: str = "data") -> List[torch.Tensor]:
    """``LowRankSpectralSolver.solve`` of every subject, the subjects split
    over ``axis``.

    Each rank solves each of its subjects by the very call the subject's
    own ``solve`` makes (one ``_lowrank_solve`` of a stack of one), so the
    gathered voltages, and the ``.dat`` bytes written from them, equal
    the single-device run's. A batched product over the block would not:
    its kernels depend on the stack's size. The subjects share one
    measurement operator: a subject whose ``meas_mat`` differs from
    ``solvers[0]``'s in shape or value raises ``ValueError`` (eitx uses
    ``solvers[0]``'s for every subject). Returns a list of (T, n_exc,
    n_meas)."""
    if not solvers:
        return []
    m0 = solvers[0].meas_mat
    for k, s in enumerate(solvers[1:], 1):
        if s.meas_mat is not m0 and (s.meas_mat.shape != m0.shape
                                     or not torch.equal(s.meas_mat, m0)):
            raise ValueError(
                f"sharded_group_solve requires one measurement protocol: "
                f"subject {k}'s meas_mat differs from subject 0's")
    local = group_solve_block(solvers, lung_alphas, *_axis(mesh, axis))
    return list(_gather(local, mesh, axis)[:len(solvers)].unbind(0))
