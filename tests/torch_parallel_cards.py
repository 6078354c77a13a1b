"""The sharded paths of eitx_torch.parallel across several cards.

    python tests/torch_parallel_cards.py --cards 4 [--out result.json]

One process a card (NCCL, joined through a FileStore in a temporary
directory). Every rank runs, and rank 0 compares with its own single-card
calls on the same inputs:

  train      train_tissue's 512 defaults (chip_smoke.py TRAIN_SEG) on a
             (data, model) = (2, 2) mesh, global batch 8: the first step's
             loss components, gradients (each leaf against its own
             largest magnitude) and batch statistics against one card's
             step from the same init on the same batch; ms per step of
             each (CUDA events, 5 steps after 2). Then a (4, 1) mesh at a
             global batch of 8 per card against one card at batch 8:
             images per second. After each mesh's steps, one sha256 over
             every leaf's (chip_smoke.state_digests): two runs of the
             script from the same seed print the same.
  monitoring sharded_eit_monitoring of the serving schedule's 100 frames
             repeated to 1200 (the .dat's rows) on an lc-7 thorax (300 a
             card) against forward_solve_batched on one card: equal, or
             the largest difference of scale; seconds and peak memory of
             each rank and of the one card.
  labels     sharded_segment_labels of 16 and of 64 flips and shifts of
             the 512^2 phantom (trained 512 checkpoint, serving settings)
             against segment_labels: agreement; seconds and peak memory
             of each rank and of the one card.
  factory    the nine chip_smoke.py factory subjects meshed on every card,
             their solvers built per node bucket and sharded_group_solve:
             every subject's .dat bytes against its own solve's.

Prints one JSON object (and writes it to ``--out``). ``--device cpu``
rehearses the same program on gloo ranks at ``--imgsz`` (e.g. 64) with
``--frames`` frames. Not collected by pytest; needs ``--cards`` cards.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms_per_step(tr, stream, steps, dev) -> float:
    """ms of one step over ``steps`` steps: CUDA events on the card, the
    host's clock on the CPU."""
    _sync(dev)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    for _ in range(steps):
        tr.train_step(next(stream), device_metrics=True)
    if dev.type == "cuda":
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / steps
    return (time.perf_counter() - t0) * 1e3 / steps


def _timed_peak(fn, dev):
    """(result, seconds, peak GiB) of ``fn()`` up to a device
    synchronisation; the peak (on the card only) is what the call
    allocates above the tensors alive before it."""
    _sync(dev)
    if dev.type == "cuda":
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = fn()
    _sync(dev)
    s = time.perf_counter() - t0
    gib = ((torch.cuda.max_memory_allocated(dev) - base) / 2**30
           if dev.type == "cuda" else None)
    return res, s, gib


def _per_rank(obj) -> list:
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def _barrier():
    import torch.distributed as dist

    dist.barrier()


def _state_sha256(trainer) -> str:
    """One sha256 over the sha256 of every leaf of ``trainer``'s state, on
    every rank of its mesh (a collective)."""
    import hashlib

    import chip_smoke as cs

    return hashlib.sha256(json.dumps(sorted(cs.state_digests(
        trainer).items())).encode()).hexdigest()


def _train(out, dev, args, rank, world):
    import torch.distributed as dist

    import chip_smoke as cs
    from eitx_torch.parallel import make_device_mesh
    from eitx_torch.train import TrainConfig, Trainer
    from eitx_torch.train.data import device_batches
    from eitx_torch.train.phantoms import phantom_batch

    cfg = TrainConfig(**dict(cs.TRAIN_SEG, imgsz=args.imgsz))
    store = phantom_batch(cs.TRAIN_SEG_STORE, args.imgsz,
                          cfg.max_instances, np.random.default_rng(0),
                          mask_res=args.imgsz // 2, store_u8=True,
                          device=dev)
    batch = cs.TRAIN_SEG_BATCH
    mesh = make_device_mesh(("data", "model"), (world // 2, 2),
                            device_type=dev.type)
    sharded = Trainer(cfg, mesh=mesh, seed=0, device=dev)
    stream = device_batches(store, batch, seed=0, device=dev)
    first = sharded.train_step(next(stream))
    grads = {n: p.grad.full_tensor() for n, p in zip(sharded._names,
                                                      sharded._params)}
    stats = {n: t.clone() for n, t in sharded.state.batch_stats.items()}
    sharded.train_step(next(stream))
    mesh_ms = _ms_per_step(sharded, stream, args.steps, dev)
    mesh_sha = _state_sha256(sharded)
    if rank == 0:
        one = Trainer(cfg, seed=0, device=dev)
        stream = device_batches(store, batch, seed=0, device=dev)
        want = one.train_step(next(stream))
        top = max(float(p.grad.abs().max()) for p in one.model.parameters())
        leaves = [float((grads[n] - p.grad).abs().max() / p.grad.abs().max())
                  for n, p in one.model.named_parameters()
                  if float(p.grad.abs().max()) > 1e-6 * top]
        want_stats = {n: t.clone() for n, t in one.state.batch_stats.items()}
        scale = max(float(t.abs().max()) for t in want_stats.values())
        one.train_step(next(stream))
        out["train_2x2"] = dict(
            batch=batch, loss_rel={k: abs(first[k] - v) / abs(v)
                                   for k, v in want.items()},
            grad_worst_leaf=max(leaves),
            grad_median_leaf=float(np.median(leaves)),
            batch_stats_of_scale=max(float((stats[n] - t).abs().max())
                                     for n, t in want_stats.items()) / scale,
            step_ms_mesh=mesh_ms, state_sha256=mesh_sha,
            step_ms_one_card=_ms_per_step(one, stream, args.steps, dev))
    dist.barrier()
    del sharded

    # data parallel: (world, 1), a batch of ``batch`` on every card
    mesh = make_device_mesh(("data", "model"), (world, 1),
                            device_type=dev.type)
    dp = Trainer(cfg, mesh=mesh, seed=0, device=dev)
    stream = device_batches(store, batch * world, seed=0, device=dev)
    for _ in range(2):
        dp.train_step(next(stream))
    dp_ms = _ms_per_step(dp, stream, args.steps, dev)
    dp_sha = _state_sha256(dp)
    if rank == 0:
        one_ms = out["train_2x2"]["step_ms_one_card"]
        out["train_dp"] = dict(
            mesh=[world, 1], global_batch=batch * world, step_ms=dp_ms,
            images_per_s=batch * world * 1e3 / dp_ms, state_sha256=dp_sha,
            one_card_images_per_s=batch * 1e3 / one_ms)


def _factory_tail(out, dev, args, rank, tmp):
    import chip_smoke as cs
    from eitx_torch.core.config import ClassMap, ModelConfig, SimulationConfig
    from eitx_torch.fem import LowRankSpectralSolver, forward_solve_batched
    from eitx_torch.fem.solver import solve_stack_frames
    from eitx_torch.mesh import create_mesh
    from eitx_torch.models.yolo.infer import TissueSegmenter
    from eitx_torch.parallel import (
        make_device_mesh,
        sharded_eit_monitoring,
        sharded_group_solve,
        sharded_segment_labels,
    )

    fmesh = make_device_mesh(("data",), device_type=dev.type)
    sim = SimulationConfig()
    systems = []
    for seed, lc in cs.FACTORY_SUBJECTS[:args.subjects]:
        _, m = create_mesh(["0.75", "0.75"], cs.thorax_polygons(seed),
                           lc=lc, show_meshing_result_method="no",
                           device=dev)
        systems.append(cs.subject_system(m, sim, dev))
    _, sigma, proto, el, css = systems[0]
    # the schedule's frames repeated up to --frames (the .dat's 1200 rows)
    frames = np.concatenate([sigma] * -(-args.frames // len(sigma)))
    frames = frames[:args.frames]
    mon_args = (css, frames, el, proto.ex_mat, proto.meas_mat)
    _barrier()
    v, s, gib = _timed_peak(lambda: sharded_eit_monitoring(
        *mon_args, mesh=fmesh), dev)
    per_rank = _per_rank((s, gib))
    if rank == 0:
        one, one_s, one_gib = _timed_peak(
            lambda: forward_solve_batched(*mon_args), dev)
        out["monitoring"] = dict(
            frames=len(frames), nodes_padded=int(css.n_nodes),
            stack_frames=solve_stack_frames(css, len(frames)),
            equal=bool(torch.equal(v, one)),
            max_abs_of_scale=float((v - one).abs().max() / one.abs().max()),
            sharded_s_per_rank=[t for t, _ in per_rank],
            sharded_peak_gib_per_rank=[g for _, g in per_rank],
            one_card_s=one_s, one_card_peak_gib=one_gib)
    del v
    _barrier()

    m = ModelConfig()
    seg = TissueSegmenter(args.imgsz, weights=os.path.join(
        ROOT, "weights", "tissue_n_512.msgpack"), variant="n",
        conf=m.axial_conf_per_class, max_det=m.max_detections,
        tta_fill=m.axial_tta_fill, dtype=m.dtype, device=dev)
    image = np.load(os.path.join(ROOT, "tests", "data",
                                 "torch_smoke_512.npz"))["image"]
    for n in (16, 64):
        imgs = cs._seg_variants(image[:args.imgsz, :args.imgsz], n)
        sharded_segment_labels(seg, imgs, fmesh)  # warm-up: cuDNN
        _barrier()
        labels, s, gib = _timed_peak(
            lambda: sharded_segment_labels(seg, imgs, fmesh), dev)
        per_rank = _per_rank((s, gib))
        if rank == 0:
            seg.segment_labels(imgs)
            one, one_s, one_gib = _timed_peak(
                lambda: seg.segment_labels(imgs), dev)
            out[f"labels_{n}"] = dict(
                images=n, agreement=float((labels == one).mean()),
                sharded_s_per_rank=[t for t, _ in per_rank],
                sharded_peak_gib_per_rank=[g for _, g in per_rank],
                one_card_s=one_s, one_card_peak_gib=one_gib)
        _barrier()

    lung = ClassMap().name_to_id()["lung"]
    alphas = sigma[:, lung]  # the schedule's frames
    groups = {}
    for i, s in enumerate(systems):
        groups.setdefault(tuple(s[4].k_class.shape), []).append(i)
    solvers = [None] * len(systems)
    for idxs in groups.values():
        built = LowRankSpectralSolver.build_batch(
            [systems[i][4] for i in idxs], sigma[0], lung,
            [systems[i][3] for i in idxs], proto.ex_mat, proto.meas_mat,
            [float(alphas.mean())] * len(idxs),
            rank_bucket=sim.spectral_rank_bucket)
        for i, sv in zip(idxs, built):
            solvers[i] = sv
    shard = sharded_group_solve(solvers, alphas, fmesh)
    if rank == 0:
        equal = [cs._dat_bytes(os.path.join(tmp, f"a{k}.dat"),
                               sv.solve(alphas), len(alphas), 12)
                 == cs._dat_bytes(os.path.join(tmp, f"b{k}.dat"), shard[k],
                                  len(alphas), 12)
                 for k, sv in enumerate(solvers)]
        out["factory"] = dict(subjects=len(solvers), buckets=len(groups),
                              dat_bytes_equal=equal)


def _cards() -> list:
    """Every card's name and power limit, as nvidia-smi gives them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()


def _rank(rank, world, args, tmp):
    import torch.distributed as dist

    from eitx_torch.parallel import init_distributed

    if args.device == "cpu":
        torch.set_num_threads(1)
    dev = init_distributed(rank, world, os.path.join(tmp, "store"),
                           args.device)
    try:
        out = {"cards": world, "device": _cards() if dev.type == "cuda"
               else "cpu"}
        t0 = time.perf_counter()
        _train(out, dev, args, rank, world)
        out["train_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _factory_tail(out, dev, args, rank, tmp)
        out["factory_tail_s"] = time.perf_counter() - t0
        if rank == 0:
            with open(os.path.join(tmp, "out.json"), "w") as fh:
                json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict:
    import torch.multiprocessing as mp

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--imgsz", type=int, default=512)
    p.add_argument("--frames", type=int, default=1200)
    p.add_argument("--subjects", type=int, default=9)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.cards:
        raise SystemExit(f"needs {args.cards} cards, has "
                         f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(args.cards, args, tmp), nprocs=args.cards)
        with open(os.path.join(tmp, "out.json")) as fh:
            out = json.load(fh)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
