"""Multi-process dry run of the sharded paths.

    python -m eitx_torch.parallel.dryrun 4                 # 4 cards
    python -m eitx_torch.parallel.dryrun 4 --device cpu    # 4 gloo ranks

The port of eitx's ``dryrun_multichip`` (``__graft_entry__.py:83-226``):
``n_devices`` processes join one process group through a ``FileStore`` in
a fresh temporary directory (no port to collide with another run's) and
each runs, at the same tiny shapes as eitx:

1. one train step on a (data, model) mesh through the mask-loss path
   (top-K positives, full-resolution masks upsampling the stride-2 proto);
2. sharded EIT monitoring, 2 frames a rank, on an inline disk mesh: equal
   to the single-process solve;
3. the dataset factory's tail: sharded segmentation equal to the single
   process's labels, every subject meshed on every rank through the
   pipeline's own functions, the sharded group solve, and the ``.dat``
   bytes of every subject equal to its single-process solve's.

Rank 0 prints eitx's ``dryrun_multichip ok: ...`` line.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def _train_step(dev, data_par: int, model_par: int) -> float:
    from ..train import TrainConfig, Trainer, synthetic_ct_batch
    from .mesh import make_device_mesh

    mesh = make_device_mesh(("data", "model"), (data_par, model_par),
                            device_type=dev.type)
    cfg = TrainConfig(imgsz=64, variant="n", total_steps=2, warmup_steps=0,
                      max_instances=4, mask_topk=48, proto_stride=2)
    trainer = Trainer(cfg, mesh=mesh, device=dev)
    batch = synthetic_ct_batch(batch=max(2, data_par), imgsz=64,
                               max_instances=4)
    # full-resolution mask targets: above the stride-2 proto grid, so the
    # loss upsamples the proto, as production training does
    batch["masks"] = batch["masks"].repeat(4, axis=2).repeat(4, axis=3)
    metrics = trainer.train_step(batch)
    if not np.isfinite(metrics["loss"]):
        raise AssertionError(f"sharded train step: {metrics}")
    return metrics["loss"]


def _monitoring(dev, fmesh, n_devices: int) -> int:
    from ..fem import (
        ClassStiffness,
        create_protocol,
        forward_solve_batched,
        place_electrodes_equal_spacing,
    )
    from ..mesh.triangulate import triangulate_polygon
    from .shard import sharded_eit_monitoring

    th = np.linspace(0, 2 * np.pi, 48, endpoint=False)
    poly = np.stack([100 + 80 * np.cos(th), 100 + 70 * np.sin(th)], 1)
    nodes, tris = triangulate_polygon(poly, lc=12)
    cls = np.ones(tris.shape[0], dtype=np.int64)
    cent = nodes[tris].mean(1)
    cls[np.linalg.norm(cent - [80, 100], axis=1) < 25] = 2
    cs = ClassStiffness.build(nodes, tris, cls, n_classes=5,
                              pad_nodes_to=64, pad_elems_to=256, device=dev)
    el = place_electrodes_equal_spacing(nodes, tris, 16,
                                        starting_angle=np.pi)
    proto = create_protocol(16, 1, 1, "std")
    T = 2 * n_devices
    sigma = np.tile([0.006, 0.35, 0.15, 0.017, 0.4], (T, 1))
    sigma[:, 2] = np.linspace(0.06, 0.18, T)
    v = sharded_eit_monitoring(cs, sigma, el, proto.ex_mat, proto.meas_mat,
                               mesh=fmesh)
    single = forward_solve_batched(cs, sigma, el, proto.ex_mat,
                                   proto.meas_mat)
    if v.shape != (T, 16, 13) or not bool(v.isfinite().all()):
        raise AssertionError(f"sharded monitoring: {tuple(v.shape)}")
    if not bool((v == single).all()):
        raise AssertionError("sharded monitoring != single-process solve")
    return T


def _factory_tail(dev, fmesh, n_sub: int, tmp: str) -> None:
    from ..core.config import ClassMap
    from ..fem import (
        ClassStiffness,
        LowRankSpectralSolver,
        create_protocol,
        lowrank_solve_batch,
        place_electrodes_equal_spacing,
    )
    from ..fem.forward import compact_mesh_nodes, prepare_mesh_info, write_dat
    from ..masks import cleanup_labels
    from ..mesh import create_mesh
    from ..models.yolo.infer import TissueSegmenter
    from ..pipeline.modes import body_polygon, labels_to_polygons
    from ..train.phantoms import phantom_batch
    from .shard import sharded_group_solve, sharded_segment_labels

    b = phantom_batch(n_sub, 192, 12, np.random.default_rng(0),
                      return_labels=True, device=dev)
    imgs = (b["images"][..., 0] * 255).astype(np.uint8)

    # segmentation: the batch over 'data' equals the single process's
    # labels (random weights: wiring, not capability)
    seg = TissueSegmenter(imgsz=192, variant="n", max_det=16, seed=3,
                          device=dev)
    if not np.array_equal(sharded_segment_labels(seg, imgs, fmesh),
                          seg.segment_labels(imgs)):
        raise AssertionError("sharded segmentation != single process")

    # every subject meshed on every rank from its phantom's labels,
    # through the pipeline's functions
    classes = ClassMap()
    proto = create_protocol(16, 1, 1, "std")
    els, css = [], []
    for s in range(n_sub):
        lab = b["labels"][s]
        body = ((lab >= 0) * 255).astype(np.uint8)
        lab = cleanup_labels(lab, body, device=dev).cpu().numpy()
        polys = labels_to_polygons(lab)
        bp = body_polygon(body)
        if bp:
            polys.append(bp)
        _, mesh_data = create_mesh(["0.75", "0.75"], polys, lc=8,
                                   skin_width=1, device=dev)
        info = compact_mesh_nodes(prepare_mesh_info(mesh_data, classes))
        els.append(place_electrodes_equal_spacing(
            info.node, info.element, 16, starting_angle=np.pi))
        css.append(ClassStiffness.build(
            info.node, info.element, info.cond, n_classes=5,
            pad_nodes_to=512, pad_elems_to=2048, device=dev))
    if len({tuple(c.k_class.shape) for c in css}) != 1:
        raise AssertionError("factory subjects split across padding buckets")

    lung = classes.name_to_id()["lung"]
    sig_c = np.array([0.006, 0.35, 0.15, 0.017, 0.4])[: classes.n_tissues]
    alphas = np.linspace(0.10, 0.18, 4)
    solvers = LowRankSpectralSolver.build_batch(
        css, sig_c, lung, els, proto.ex_mat, proto.meas_mat,
        [float(sig_c[lung])] * n_sub)
    v_single = [s.solve(alphas).cpu().numpy() for s in solvers]
    for a, g in zip(v_single, lowrank_solve_batch(solvers, alphas)):
        np.testing.assert_allclose(g.cpu().numpy(), a, rtol=5e-6, atol=1e-7)
    v_shard = sharded_group_solve(solvers, alphas, fmesh)
    rank = fmesh.get_rank()
    for s in range(n_sub):
        pa = os.path.join(tmp, f"single_{rank}_{s}.dat")
        pb = os.path.join(tmp, f"shard_{rank}_{s}.dat")
        write_dat(pa, v_single[s].reshape(len(alphas), -1), n_repeats=2)
        write_dat(pb, v_shard[s].cpu().numpy().reshape(len(alphas), -1),
                  n_repeats=2)
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(
                    f"subject {s}: sharded .dat bytes != single process")


def _rank(rank: int, n_devices: int, store: str, device_type: str,
          tmp: str) -> None:
    import torch
    import torch.distributed as dist

    from .mesh import init_distributed, make_device_mesh

    if device_type == "cpu":
        torch.set_num_threads(1)  # n processes share the host's cores
    dev = init_distributed(rank, n_devices, store, device_type)
    try:
        model_par = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
        data_par = n_devices // model_par
        loss = _train_step(dev, data_par, model_par)
        fmesh = make_device_mesh(("data",), device_type=device_type)
        T = _monitoring(dev, fmesh, n_devices)
        n_sub = max(2, data_par)
        _factory_tail(dev, fmesh, n_sub, tmp)
        dist.barrier()
        if rank == 0:
            print(f"dryrun_multichip ok: mesh=({data_par}x{model_par}), "
                  f"train loss={loss:.3f}, fem frames={T}, "
                  f"factory tail: {n_sub} subjects seg+mesh+solve sharded, "
                  ".dat byte-equal", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> None:
    """Spawn ``n_devices`` ranks on ``device_type`` ("cuda": NCCL, one
    card a rank; "cpu": gloo) and run the three steps; raises if a rank
    fails."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(n_devices, os.path.join(tmp, "store"),
                              device_type, tmp), nprocs=n_devices)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_devices", type=int, nargs="?", default=8)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
