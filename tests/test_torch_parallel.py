"""The port's sharded paths (eitx_torch.parallel, Trainer(mesh=...)) on 4
gloo ranks against the single-device port and against eitx's sharded
paths on the conftest's 8 virtual CPU devices, restricted to the first 4.

One module-scoped spawn of 4 ranks (tests/torch_parallel_worker.py) runs
every case and rank 0 hands back the readings; the tests assert on them.
The dry run spawns its own 4 ranks."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eitx.fem.assembly import ClassStiffness as JaxClassStiffness
from eitx.fem.electrodes import place_electrodes_equal_spacing as jax_el
from eitx.fem.protocol import create_protocol as jax_protocol
from eitx.models.yolo.infer import TissueSegmenter as EitxSegmenter
from eitx.parallel import make_device_mesh as jax_mesh
from eitx.parallel import shard_batch as jax_shard_batch
from eitx.parallel import shard_params_fsdp as jax_shard_params
from eitx.parallel.shard import sharded_eit_monitoring as jax_monitoring
from eitx.parallel.shard import sharded_segment_labels as jax_segment
from eitx.train import TrainConfig as JaxConfig
from eitx.train import Trainer as JaxTrainer
from eitx.train import synthetic_ct_batch
from eitx_torch.mesh.triangulate import triangulate_polygon
from eitx_torch.models.yolo.checkpoint import flax_to_torch_state
from eitx_torch.parallel.shard import fsdp_shard_dim
from eitx_torch.train import TrainConfig, Trainer, TrainState
from eitx_torch.train.phantoms import phantom_batch
from torch_bounds import bounded
import torch_parallel_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_256 = os.path.join(ROOT, "weights", "tissue_n_256.msgpack")
CFG = worker.TRAIN_CFG


def _disk(rx=80.0, ry=70.0, lc=12.0):
    """A small two-class disk mesh: (nodes, tris, element classes)."""
    th = np.linspace(0, 2 * np.pi, 48, endpoint=False)
    poly = np.stack([100 + rx * np.cos(th), 100 + ry * np.sin(th)], 1)
    nodes, tris = triangulate_polygon(poly, lc=lc)
    cls = np.ones(tris.shape[0], dtype=np.int64)
    cls[np.linalg.norm(nodes[tris].mean(1) - [80, 100], axis=1) < 25] = 2
    return nodes, tris, cls


def _rel_to_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def jax_side():
    """eitx's (2, 2) Trainer on the first 4 virtual devices, its initial
    parameters in the port's names, and the global batch of 4."""
    devs = jax.devices()[:4]
    mesh = jax_mesh(("data", "model"), (2, 2), devices=devs)
    jt = JaxTrainer(JaxConfig(**CFG), mesh=mesh)
    init = flax_to_torch_state(jax.device_get(jt.state.params),
                               jax.device_get(jt.state.batch_stats))
    batch = synthetic_ct_batch(4, CFG["imgsz"], 4, seed=1)
    return dict(jt=jt, mesh=mesh, devs=devs, init=init, batch=batch)


@pytest.fixture(scope="module")
def readings(jax_side, tmp_path_factory):
    """Every case of the port on 4 gloo ranks, from one spawn."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path_factory.mktemp("ranks"))
    b = phantom_batch(6, worker.SEG_IMGSZ, 12, np.random.default_rng(4),
                      device="cpu")
    seg_images = (b["images"][..., 0] * 255).astype(np.uint8)
    subjects = [_disk(80 + 2 * k, 70 - k) for k in range(6)]
    torch.save(dict(init=jax_side["init"], batch=jax_side["batch"],
                    disk=_disk(), subjects=subjects, seg_images=seg_images,
                    seg_weights=CKPT_256),
               os.path.join(tmp, "inputs.pt"))
    mp.spawn(worker.run, args=(tmp,), nprocs=worker.WORLD)
    with open(os.path.join(tmp, "readings.pkl"), "rb") as fh:
        out = pickle.load(fh)
    out["seg_images"] = seg_images
    return out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # never set back above 1: a batched float32 linalg.solve (oneMKL)
    # later in the same worker can then hang
    torch.set_num_threads(1)


# --- mesh, batch, parameters ------------------------------------------------

def test_make_device_mesh_shapes_and_bad_shape(readings):
    """eitx's default: every rank on the first axis; a shape whose product
    is not the rank count raises ValueError, as eitx's does."""
    assert readings["mesh_default"] == ((4, 1), ("data", "model"))
    assert readings["mesh_2x2"][:2] == ((2, 2), ("data", "model"))
    assert readings["mesh_2x2"][2:] == (0, 0)  # rank 0's coordinates
    for shape in ((3, 1), (4, 2)):
        assert "!= device count 4" in readings[f"mesh_bad_{shape}"]
        with pytest.raises(ValueError, match="device count"):
            jax_mesh(("data", "model"), shape, devices=jax.devices()[:4])


def test_shard_batch_blocks(readings, jax_side):
    """Rank (d, m) holds block d of the global batch, as eitx places it
    on the (2, 2) mesh; an uneven batch raises."""
    x = np.arange(8 * 3).reshape(8, 3)
    placed = jax_shard_batch(x, jax_side["mesh"])
    want = {}
    for shard in placed.addressable_shards:
        want[jax_side["devs"].index(shard.device)] = np.asarray(shard.data)
    for rank, (block, tshape) in enumerate(readings["shard_batch_blocks"]):
        np.testing.assert_array_equal(np.asarray(block), want[rank])
        assert tuple(tshape) == (4, 3)
    assert "does not split" in readings["shard_batch_uneven"]


def _eitx_shard_dims(params, mesh):
    """eitx's placement of each leaf -> the sharded dimension's extent
    (0 where replicated), as a tree of filled arrays."""
    placed = jax_shard_params(params, mesh)

    def extent(p):
        spec = tuple(p.sharding.spec) + (None,) * p.ndim
        dims = [d for d in range(p.ndim) if spec[d] == "model"]
        return np.full(p.shape, p.shape[dims[0]] if dims else 0, np.float32)

    return jax.tree_util.tree_map(extent, placed)


def test_shard_params_fsdp_follows_eitx_rule(readings, jax_side):
    """eitx's rule decides which parameters are split over 'model' and on
    which dimension: test_train.py's shapes (w (64, 512) on its 512 axis,
    b (7,) replicated) and every network parameter, compared by the
    extent of the split dimension (the port's kernels are OIHW, eitx's
    HWIO). Where eitx replicates, FSDP2 splits on dimension 0 (a
    deliberate difference: the parameters are gathered whole before use,
    so no number changes)."""
    toy = readings["fsdp_toy"]
    # (replicated over 'data', the dimension split over 'model')
    assert toy["w"][1:] == ([None, 1], (64, 256))
    assert toy["b"][1] == [None, 0]
    assert fsdp_shard_dim((64, 512), 2) == 1
    assert fsdp_shard_dim((7,), 2) is None
    ext = _eitx_shard_dims(jax_side["jt"].state.params, jax_side["mesh"])
    want = flax_to_torch_state(jax.device_get(ext), {})
    net = readings["fsdp_net"]
    assert set(want) == set(net)
    n_sharded = 0
    for name, (shape, placement, _) in net.items():
        extent = int(want[name].flatten()[0]) if want[name].numel() else 0
        d = fsdp_shard_dim(shape, 2)
        assert placement == [None, d or 0], name
        assert (extent > 0) == (d is not None), name
        if d is not None:
            assert shape[d] == extent, name
            n_sharded += 1
    assert n_sharded > 10


# --- the sharded factory tail -----------------------------------------------

def test_sharded_segment_labels_equal_single_and_agree_with_eitx(
        readings, record_property):
    """6 phantom slices over 4 ranks (padded to 8): equal to the port's
    single-device labels on every pixel; against eitx's sharded labels at
    test_torch_yolo.py's float32 agreement bound."""
    got = readings["seg_sharded"]
    np.testing.assert_array_equal(got, readings["seg_single"])
    assert got.shape == (6, worker.SEG_IMGSZ, worker.SEG_IMGSZ)
    assert len(np.unique(got)) >= 3  # the case tests labels, not background
    seg = EitxSegmenter(worker.SEG_IMGSZ, weights=CKPT_256, variant="n",
                        max_det=16, dtype="float32")
    ref = jax_segment(seg, readings["seg_images"],
                      jax_mesh(("data",), devices=jax.devices()[:4]))
    bounded(record_property, "agreement with eitx", (got == ref).mean(),
            ">=", 0.999)


def test_sharded_eit_monitoring_equal_single_and_near_eitx(
        readings, record_property):
    """8 frames, 2 a rank: equal to the port's one-device solve; within
    test_spectral.py:81's rtol 2e-4 / atol 1e-7 of eitx's sharded run."""
    got = readings["mon_sharded"]
    np.testing.assert_array_equal(got, readings["mon_single"])
    # in stacks of 3 frames: the ranks' blocks of 2 solved in stacks of
    # the single call's size, equal to it and to one stack's voltages
    # within 1e-6 of scale
    assert readings["mon_stack"] == 3
    np.testing.assert_array_equal(readings["mon_stacked_sharded"],
                                  readings["mon_stacked_single"])
    bounded(record_property, "stacks of 3 vs one stack, of scale",
            _rel_to_max(readings["mon_stacked_single"], got), "<=", 1e-6)
    nodes, tris, cls = _disk()
    cs = JaxClassStiffness.build(nodes, tris, cls, n_classes=5,
                                 pad_nodes_to=128, pad_elems_to=256)
    el = jax_el(nodes, tris, 16, starting_angle=np.pi)
    proto = jax_protocol(16, 1, 1, "std")
    ref = jax_monitoring(cs, worker.disk_sigma(worker.DISK_FRAMES), el,
                         proto.ex_mat, proto.meas_mat,
                         mesh=jax_mesh(("data",), devices=jax.devices()[:4]))
    assert got.shape == ref.shape == (worker.DISK_FRAMES, 16, 13)
    gap = np.abs(got - ref) / (1e-7 + 2e-4 * np.abs(ref))
    bounded(record_property, "allclose ratio vs eitx", gap.max(), "<=", 1.0)


def test_sharded_group_solve_dat_bytes_and_meas_guard(readings):
    """6 subjects over 4 ranks (padded to 8): every subject's .dat bytes
    equal its own solve's; a subject whose meas_mat has the shape but not
    the values of subject 0's raises ValueError."""
    assert readings["group_dat_equal"] == [True] * 6
    assert "meas_mat differs" in readings["group_guard"]


# --- the (2, 2) train step --------------------------------------------------

def _one_device_step(init, batch):
    tr = Trainer(TrainConfig(**CFG), device="cpu")
    like = tr.state
    tr.state = TrainState(params={n: init[n] for n in like.params},
                          batch_stats={n: init[n] for n in like.batch_stats},
                          opt_state=tr.init_opt_state(), step=0)
    p0 = {n: p.detach().clone() for n, p in tr.state.params.items()}
    metrics = tr.train_step(batch)
    return dict(
        metrics=metrics,
        grads={n: p.grad.numpy() for n, p in tr.state.params.items()},
        updates={n: (p.detach() - p0[n]).numpy()
                 for n, p in tr.state.params.items()},
        batch_stats={n: t.numpy() for n, t in tr.state.batch_stats.items()})


@pytest.fixture(scope="module")
def eitx_step(jax_side):
    """eitx's step under its (2, 2) sharding, in the port's names: loss
    components and gradients of its loss program on the sharded state and
    batch, then its optimizer on them (what its train step runs)."""
    import optax

    from eitx.parallel import shard_batch

    jt, mesh, batch = jax_side["jt"], jax_side["mesh"], jax_side["batch"]
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    b["valid"] = b["valid"].astype(jnp.float32)
    b = {k: shard_batch(v, mesh) for k, v in b.items()}
    params = jt.state.params
    (_, (stats, metrics)), grads = jax.jit(jax.value_and_grad(
        jt._loss_fn, has_aux=True))(params, jt.state.batch_stats, b)
    upd, _ = jax.jit(jt.tx.update)(grads, jt.state.opt_state, params)
    upd = jax.device_get(jax.jit(optax.apply_updates)(params, upd))
    upd = jax.tree_util.tree_map(lambda a, c: np.asarray(a) - np.asarray(c),
                                 upd, jax.device_get(params))
    return dict(
        metrics=metrics,
        grads={n: t.numpy() for n, t in flax_to_torch_state(
            jax.device_get(grads), {}).items()},
        updates={n: t.numpy() for n, t in flax_to_torch_state(
            upd, {}).items()},
        batch_stats={n: t.numpy() for n, t in flax_to_torch_state(
            {}, jax.device_get(stats)).items()})


def _step_errors(got, want, skip=()):
    """test_torch_train.py's single-step measures: each loss component's
    relative error; the worst and median leaf's gradient error of its own
    largest magnitude (leaves zero in exact arithmetic, and ``skip``, left
    out); the update where |g| > 0.1 of its leaf, in units of lr; the
    batch statistics of their overall scale."""
    errs = {k: abs(got["metrics"][k] - float(v)) / abs(float(v))
            for k, v in want["metrics"].items()}
    g_want = want["grads"]
    top = max(float(np.abs(g).max()) for g in g_want.values())
    leaves = [_rel_to_max(got["grads"][n], g) for n, g in g_want.items()
              if np.abs(g).max() > 1e-6 * top and n not in skip]
    upd = 0.0
    for n, g in g_want.items():
        g = np.abs(g)
        if g.max() <= 1e-6 * top:
            continue
        big = g > 0.1 * g.max()
        upd = max(upd, float(np.abs(got["updates"][n][big]
                                    - want["updates"][n][big]).max(
            initial=0.0)) / CFG["lr"])
    scale = max(float(np.abs(s).max()) for s in want["batch_stats"].values())
    stats = max(float(np.abs(got["batch_stats"][n] - s).max())
                for n, s in want["batch_stats"].items()) / scale
    return dict(loss=max(errs.values()), grad_worst=max(leaves),
                grad_median=float(np.median(leaves)), update=upd,
                stats=stats, n_leaves=len(leaves), n_all=len(g_want))


BOUNDS = dict(loss=1e-5, grad_worst=2e-2, grad_median=5e-3, update=2e-3,
              stats=5e-5)


def _assert_step(record_property, what, errs):
    assert errs["n_leaves"] > 0.8 * errs["n_all"]
    for k, bound in BOUNDS.items():
        bounded(record_property, f"{what} {k}", errs[k], "<=", bound)


def test_sharded_train_step_matches_one_device_step(
        readings, jax_side, record_property):
    """The (data, model) = (2, 2) step on 4 ranks computes the port's
    one-device step on the same global batch of 4 from the same
    parameters, at test_torch_train.py's single-step bounds; every rank
    reports the same metrics (means over 'data')."""
    want = _one_device_step(jax_side["init"], jax_side["batch"])
    _assert_step(record_property, "vs one device",
                 _step_errors(readings["step"], want))
    metrics = [m for m, *_ in readings["per_rank"]]
    assert all(m == metrics[0] for m in metrics)


# eitx's step on its (2, 2) mesh doubles the gradient of the three
# depthwise convolutions cv3_{i}_1_0 of the class head against its own step
# on one device and on (4, 1) and (1, 4) meshes (XLA's SPMD partition of
# a grouped convolution's kernel gradient on the CPU adds the 'model'
# replicas' equal halves once too often). The port's step has eitx's
# one-device gradient there.
EITX_DOUBLED = tuple(f"model.23.cv3.{i}.1.0.conv.weight" for i in range(3))


def test_sharded_train_step_matches_eitx_sharded_step(
        readings, eitx_step, record_property):
    """The port's (2, 2) step against eitx's Trainer(mesh=(2, 2)) step
    from the same converted parameters, at the same bounds, on every
    leaf but the three that eitx's sharding doubles; on those eitx's
    gradient is twice the port's (to 1e-3 of its scale)."""
    _assert_step(record_property, "vs eitx (2, 2)",
                 _step_errors(readings["step"], eitx_step, EITX_DOUBLED))
    for n in EITX_DOUBLED:
        bounded(record_property, f"{n}: eitx - 2 x port, of scale",
                _rel_to_max(2.0 * readings["step"]["grads"][n],
                            eitx_step["grads"][n]), "<=", 1e-3)


def test_step_without_batchnorm_allreduce_fails_the_bound(
        readings, jax_side, record_property):
    """The control: the same (2, 2) step with BatchNorm's all-reduce
    switched off (each rank's 2 images alone) falls outside the bounds
    that the step above meets, so they can see the difference."""
    want = _one_device_step(jax_side["init"], jax_side["batch"])
    errs = _step_errors(readings["step_no_bn_sync"], want)
    record_property("control errors", errs)
    assert any(errs[k] > bound for k, bound in BOUNDS.items()), errs
    assert errs["loss"] > 100 * BOUNDS["loss"], errs


def test_sharded_fit_checkpoint_and_ema(readings):
    """fit on the mesh: one .train file, written by rank 0, that loads back
    into the sharded trainer's whole state; EMA parameters come back
    whole on every rank."""
    fit = readings["fit"]
    assert fit["finite"] and fit["step"] == 2
    assert fit["ema_shapes_whole"]
    assert fit["params_round_trip"] and fit["moments_round_trip"]
    assert [f for _, f, _ in readings["per_rank"]] == [["sharded.train"]] * 4


def test_meshless_checkpoint_writes_on_every_rank_of_a_group(readings):
    """A trainer without a mesh, in a process group of 4: save_checkpoint
    is a plain writer, so every rank writes its own file (and no rank
    waits on a collective the others never enter)."""
    assert [w for *_, w in readings["per_rank"]] == [True] * 4


def test_dryrun_multichip_prints_ok(capfd):
    """eitx's dry run on 4 gloo ranks: the (2 x 2) train step, sharded
    monitoring equal to single, the factory tail's .dat bytes equal."""
    from eitx_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4, "cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip ok: mesh=(2x2)" in out
    assert ".dat byte-equal" in out
