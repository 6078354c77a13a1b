"""The ranks of tests/test_torch_parallel.py: one spawn of 4 gloo ranks
runs every sharded case of the port and rank 0 pickles the readings for
the tests to assert on. Imports torch and eitx_torch only (the ranks
start from a fresh import). Not collected by pytest.

Inputs, written by the test module into ``tmp``: ``inputs.pt`` (the
converted initial parameters, the train batch, the disk mesh and the
segmentation images).
"""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
TRAIN_CFG = dict(imgsz=64, variant="n", max_instances=4, total_steps=10,
                 warmup_steps=0, lr=1e-4, assigner="center")
SEG_IMGSZ = 128
DISK_FRAMES = 8  # 2 a rank
ALPHAS = np.linspace(0.10, 0.18, 5)


def disk_sigma(T: int) -> np.ndarray:
    sigma = np.tile([0.006, 0.35, 0.15, 0.017, 0.4], (T, 1))
    sigma[:, 2] = np.linspace(0.06, 0.18, T)
    return sigma


def _mesh_cases(out):
    from eitx_torch.parallel import make_device_mesh

    m = make_device_mesh(device_type="cpu")
    out["mesh_default"] = (tuple(m.mesh.shape), m.mesh_dim_names)
    m = make_device_mesh(("data", "model"), (2, 2), device_type="cpu")
    out["mesh_2x2"] = (tuple(m.mesh.shape), m.mesh_dim_names,
                       m.get_local_rank("data"), m.get_local_rank("model"))
    for shape in ((3, 1), (4, 2)):
        try:
            make_device_mesh(("data", "model"), shape, device_type="cpu")
            out[f"mesh_bad_{shape}"] = None
        except ValueError as e:
            out[f"mesh_bad_{shape}"] = str(e)


def _shard_batch_cases(out, mesh):
    from eitx_torch.parallel import shard_batch

    x = np.arange(8 * 3).reshape(8, 3)
    blocks = [None] * WORLD
    dist.all_gather_object(blocks, (shard_batch(x, mesh).tolist(),
                                    shard_batch(torch.tensor(x), mesh).shape))
    out["shard_batch_blocks"] = blocks
    try:
        shard_batch(x[:5], mesh)
        out["shard_batch_uneven"] = None
    except ValueError as e:
        out["shard_batch_uneven"] = str(e)


def _fsdp_cases(out, mesh2):
    from eitx_torch.models.yolo.model import YoloV11, yolov11_spec
    from eitx_torch.parallel import shard_params_fsdp

    toy = torch.nn.Module()
    toy.w = torch.nn.Parameter(torch.zeros(64, 512))
    toy.b = torch.nn.Parameter(torch.zeros(7))
    shard_params_fsdp(toy, mesh2)
    net = YoloV11(yolov11_spec("n", nc=4, segment=True, proto_stride=4))
    shard_params_fsdp(net, mesh2)

    def placements(mod):
        return {n: (tuple(p.shape),
                    [pl.dim if pl.is_shard() else None
                     for pl in p.placements],
                    tuple(p.to_local().shape))
                for n, p in mod.named_parameters()}

    out["fsdp_toy"] = placements(toy)
    out["fsdp_net"] = placements(net)


def _segment_cases(out, fmesh, images, weights):
    from eitx_torch.models.yolo.infer import TissueSegmenter
    from eitx_torch.parallel import sharded_segment_labels

    seg = TissueSegmenter(SEG_IMGSZ, weights=weights, variant="n",
                          max_det=16, dtype="float32", device="cpu")
    out["seg_sharded"] = sharded_segment_labels(seg, images, fmesh)
    out["seg_single"] = seg.segment_labels(images)


def _disk_system(nodes, tris, cls):
    from eitx_torch.fem import (
        ClassStiffness,
        create_protocol,
        place_electrodes_equal_spacing,
    )

    cs = ClassStiffness.build(nodes, tris, cls, n_classes=5,
                              pad_nodes_to=128, pad_elems_to=256,
                              device="cpu")
    el = place_electrodes_equal_spacing(nodes, tris, 16, starting_angle=np.pi)
    return cs, el, create_protocol(16, 1, 1, "std")


def _monitoring_cases(out, fmesh, disk):
    from eitx_torch.fem import forward_solve_batched
    from eitx_torch.parallel import sharded_eit_monitoring

    cs, el, proto = _disk_system(*disk)
    sigma = disk_sigma(DISK_FRAMES)
    out["mon_sharded"] = sharded_eit_monitoring(
        cs, sigma, el, proto.ex_mat, proto.meas_mat, mesh=fmesh).numpy()
    out["mon_single"] = forward_solve_batched(
        cs, sigma, el, proto.ex_mat, proto.meas_mat).numpy()
    # stacks of 3 frames (K(t) capped at 3 frames' bytes): the single
    # call's stacks [0, 3), [3, 6), [6, 8) + 1, each rank's 2 frames + 1
    from eitx_torch.fem import solver

    whole = solver.SOLVE_STACK_BYTES
    solver.SOLVE_STACK_BYTES = 3 * cs.n_nodes ** 2 * cs.k_class.element_size()
    try:
        out["mon_stack"] = solver.solve_stack_frames(cs, DISK_FRAMES)
        out["mon_stacked_sharded"] = sharded_eit_monitoring(
            cs, sigma, el, proto.ex_mat, proto.meas_mat, mesh=fmesh).numpy()
        out["mon_stacked_single"] = forward_solve_batched(
            cs, sigma, el, proto.ex_mat, proto.meas_mat).numpy()
    finally:
        solver.SOLVE_STACK_BYTES = whole


def _group_solve_cases(out, fmesh, subjects, tmp):
    from dataclasses import replace

    from eitx_torch.fem import LowRankSpectralSolver
    from eitx_torch.fem.forward import write_dat
    from eitx_torch.parallel import sharded_group_solve

    systems = [_disk_system(*s) for s in subjects]
    proto = systems[0][2]
    sig = np.array([0.006, 0.35, 0.15, 0.017, 0.4])
    solvers = LowRankSpectralSolver.build_batch(
        [s[0] for s in systems], sig, 2, [s[1] for s in systems],
        proto.ex_mat, proto.meas_mat, [0.15] * len(systems))
    shard = sharded_group_solve(solvers, ALPHAS, fmesh)
    equal = []
    for k, s in enumerate(solvers):
        blobs = []
        for tag, v in (("single", s.solve(ALPHAS)), ("shard", shard[k])):
            path = os.path.join(tmp, f"{tag}_{dist.get_rank()}_{k}.dat")
            write_dat(path, v.numpy().reshape(len(ALPHAS), -1), n_repeats=2)
            with open(path, "rb") as fh:
                blobs.append(fh.read())
        equal.append(blobs[0] == blobs[1])
    out["group_dat_equal"] = equal
    other = solvers[1].meas_mat.clone()
    other[0, 0] = other[0, 0] + 1  # same shape, another protocol
    try:
        sharded_group_solve([solvers[0], replace(solvers[1], meas_mat=other)]
                            + solvers[2:], ALPHAS, fmesh)
        out["group_guard"] = None
    except ValueError as e:
        out["group_guard"] = str(e)


def _train_step(mesh2, init, batch, bn_sync: bool):
    """One step of the (2, 2) trainer from ``init``: loss components,
    whole gradients, updates and batch statistics."""
    from eitx_torch.models.yolo.blocks import BatchNorm2d
    from eitx_torch.train import TrainConfig, Trainer, TrainState

    tr = Trainer(TrainConfig(**TRAIN_CFG), mesh=mesh2, device="cpu")
    like = tr.state
    tr.state = TrainState(
        params={n: init[n] for n in like.params},
        batch_stats={n: init[n] for n in like.batch_stats},
        opt_state=like.opt_state, step=0)
    if not bn_sync:  # the control: each rank's images alone
        for m in tr.model.modules():
            if isinstance(m, BatchNorm2d):
                m.sync_group = None
    p0 = tr.state.params
    metrics = tr.train_step(batch)
    grads = {n: p.grad.full_tensor().numpy()
             for n, p in zip(tr._names, tr._params)}
    st = tr.state
    return tr, dict(
        metrics=metrics, grads=grads,
        updates={n: (st.params[n] - p0[n]).numpy() for n in p0},
        batch_stats={n: t.numpy().copy() for n, t in st.batch_stats.items()})


def _fit_case(out, tr, batch, tmp):
    from eitx_torch.train import Trainer
    from eitx_torch.train.checkpoint import (
        load_checkpoint,
        peek_step,
        save_checkpoint,
    )
    from eitx_torch.train.trainer import fit

    path = os.path.join(tmp, "sharded.train")
    metrics, ema = fit(tr, iter([batch]), steps=1, log_every=0,
                       checkpoint_path=path)
    st = tr.state
    back = load_checkpoint(path, st)
    out["fit"] = dict(
        finite=bool(np.isfinite(metrics["loss"])),
        step=peek_step(path),
        ema_shapes_whole=all(tuple(ema[n].shape) == tuple(p.shape)
                             for n, p in st.params.items()),
        params_round_trip=all(torch.equal(back.params[n], p)
                              for n, p in st.params.items()),
        moments_round_trip=all(torch.equal(back.opt_state.nu[n], t)
                               for n, t in st.opt_state.nu.items()),
        files=sorted(f for f in os.listdir(tmp) if f.endswith(".train")))
    # a trainer without a mesh in a process group: a plain writer on
    # every rank, each its own file, no collective
    os.makedirs(os.path.join(tmp, "meshless"), exist_ok=True)
    own = os.path.join(tmp, "meshless", f"rank{dist.get_rank()}.train")
    save_checkpoint(own, Trainer(tr.cfg, seed=0, device="cpu").state)
    out["fit"]["meshless_written"] = peek_step(own) == 0


def run(rank: int, tmp: str) -> None:
    from eitx_torch.parallel import init_distributed, make_device_mesh

    torch.set_num_threads(1)  # four ranks share the worker's cores
    init_distributed(rank, WORLD, os.path.join(tmp, "store"), "cpu")
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"),
                            weights_only=False)
        out = {}
        _mesh_cases(out)
        fmesh = make_device_mesh(("data",), device_type="cpu")
        mesh2 = make_device_mesh(("data", "model"), (2, 2),
                                 device_type="cpu")
        _shard_batch_cases(out, mesh2)
        _fsdp_cases(out, mesh2)
        _segment_cases(out, fmesh, inputs["seg_images"],
                       inputs["seg_weights"])
        _monitoring_cases(out, fmesh, inputs["disk"])
        _group_solve_cases(out, fmesh, inputs["subjects"], tmp)
        tr, out["step"] = _train_step(mesh2, inputs["init"],
                                      inputs["batch"], True)
        _, out["step_no_bn_sync"] = _train_step(mesh2, inputs["init"],
                                                inputs["batch"], False)
        _fit_case(out, tr, inputs["batch"], tmp)
        ranks = [None] * WORLD
        dist.all_gather_object(ranks, (out["step"]["metrics"],
                                       out["fit"]["files"],
                                       out["fit"]["meshless_written"]))
        out["per_rank"] = ranks
        if rank == 0:
            with open(os.path.join(tmp, "readings.pkl"), "wb") as fh:
                pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()
