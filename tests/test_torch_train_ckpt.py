"""Checkpoints across the two packages: the port's msgpack writer is the
bytes flax writes; ``.train`` files and deployment files written by
either package load in the other (parameters, BatchNorm statistics,
optax's adamw state and the step); the ``.pt`` reader and converter on
synthetic archives; and ``train_tissue`` / ``train_ribs`` run end to end
on the CPU, their checkpoints labelling an image the same through eitx's
runners and the port's."""

import os
import pickle
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from eitx.models.yolo import convert as jax_convert
from eitx.models.yolo.infer import RibsDetector as EitxRibs
from eitx.models.yolo.infer import TissueSegmenter as EitxSegmenter
from eitx.train import checkpoint as jax_ckpt
from eitx.train.phantoms import frontal_rib_phantom, phantom_batch
from eitx.train.trainer import TrainState as JaxState
from eitx_torch.core.errors import ModelError
from eitx_torch.models.yolo import convert as port_convert
from eitx_torch.models.yolo.ptread import load_pt_archive
from eitx_torch.models.yolo.checkpoint import (
    flax_path,
    flax_to_torch_state,
    packb,
    torch_to_flax_tree,
    unpackb,
)
from eitx_torch.models.yolo.infer import RibsDetector, TissueSegmenter
from eitx_torch.models.yolo.model import YoloV11, yolov11_spec
from eitx_torch.train import TrainConfig, Trainer
from eitx_torch.train import checkpoint as port_ckpt
from torch_bounds import bounded

IMG = 64


def _tx(cfg):
    return optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, cfg.lr, cfg.warmup_steps,
                                           cfg.total_steps),
        weight_decay=cfg.weight_decay))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The network's CPU steps on one thread: the parallel test workers
    share the cores, and torch's thread pools in every worker at once
    spin against each other."""
    # never set back above 1: a batched float32 linalg.solve (oneMKL)
    # later in the same worker can then hang
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stepped():
    """A port Trainer after two optimizer steps (moments and count not
    trivial)."""
    from eitx_torch.train.data import synthetic_ct_batch

    tr = Trainer(TrainConfig(imgsz=IMG, variant="n", max_instances=4,
                             warmup_steps=1, total_steps=10,
                             assigner="center"), device="cpu")
    for seed in (1, 2):
        tr.train_step(synthetic_ct_batch(2, IMG, 4, seed=seed))
    return tr


def test_packb_writes_flax_bytes(tmp_path):
    """Sorted maps as flax.serialization.msgpack_serialize writes a tree;
    the top level in insertion order over sorted subtrees as
    serialization.to_bytes writes eitx's checkpoint payload (whose
    subtrees come out of jax tree maps, keys sorted): byte for byte."""
    rng = np.random.default_rng(0)
    tree = {"params": {"b": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(
        np.float32)}, "a": {"bias": np.zeros(4, np.float32)}},
        "step": 3, "neg": -5, "big": 70000, "huge": 2 ** 40,
        "f": 1.5, "s": "x" * 40, "t": None, "b": True, "l": [1, 2],
        "e": {}, "c": np.asarray(7, np.int32),
        "u8": np.arange(300, dtype=np.int64).astype(np.uint8),
        "meta": {"variant": "n", "mask_class_w": None}}
    assert packb(tree) == serialization.msgpack_serialize(tree)
    del tree["l"]  # to_bytes writes a list as a map of its indices
    payload = {k: jax.tree_util.tree_map(lambda x: x, v)
               for k, v in tree.items()}
    assert packb(tree, sort_keys=False) == serialization.to_bytes(payload)
    assert serialization.msgpack_restore(packb(tree))["huge"] == 2 ** 40


def _like(tr, cfg):
    """An eitx TrainState template of the port trainer's structure (no
    JAX network is built)."""
    params, _ = torch_to_flax_tree(tr.state.params)
    _, stats = torch_to_flax_tree(tr.state.batch_stats)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    return JaxState(params=zeros,
                    batch_stats=jax.tree_util.tree_map(np.zeros_like, stats),
                    opt_state=_tx(cfg).init(zeros), step=0)


def test_port_train_file_loads_in_eitx(stepped, tmp_path):
    path = str(tmp_path / "port.train")
    port_ckpt.save_checkpoint(path, stepped.state)
    assert jax_ckpt.peek_step(path) == 2
    got = jax_ckpt.load_checkpoint(path, _like(stepped, stepped.cfg))
    assert got.step == 2
    params = flax_to_torch_state(jax.device_get(got.params), {})
    for n, p in stepped.state.params.items():
        np.testing.assert_array_equal(params[n].numpy(), p.detach().numpy())
    stats = flax_to_torch_state({}, jax.device_get(got.batch_stats))
    for n, t in stepped.state.batch_stats.items():
        np.testing.assert_array_equal(stats[n].numpy(), t.numpy())
    adam = got.opt_state[1][0]
    assert int(adam.count) == int(got.opt_state[1][2].count) == 2
    mu = flax_to_torch_state(jax.device_get(adam.mu), {})
    nu = flax_to_torch_state(jax.device_get(adam.nu), {})
    for n in stepped.state.params:
        np.testing.assert_array_equal(mu[n].numpy(),
                                      stepped.opt_state.mu[n].numpy())
        np.testing.assert_array_equal(nu[n].numpy(),
                                      stepped.opt_state.nu[n].numpy())
    # and the port reads back its own file, equal on every tensor
    fresh = Trainer(stepped.cfg, device="cpu")
    back = port_ckpt.load_checkpoint(path, fresh.state)
    assert back.step == 2 and back.opt_state.count == 2
    for n, p in stepped.state.params.items():
        assert torch.equal(back.params[n], p.detach())


def test_eitx_train_file_loads_in_port(stepped, tmp_path):
    """eitx's save_checkpoint on an adamw state that took updates: the
    port restores parameters, statistics, both moments and the count; the
    flax bytes re-encode identically through the port's reader/writer."""
    cfg = stepped.cfg
    tx = _tx(cfg)
    params, _ = torch_to_flax_tree(stepped.state.params)
    _, stats = torch_to_flax_tree(stepped.state.batch_stats)
    opt = tx.init(params)
    rng = np.random.default_rng(1)
    update, apply = jax.jit(tx.update), jax.jit(optax.apply_updates)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        upd, opt = update(g, opt, params)
        params = apply(params, upd)
    path = str(tmp_path / "eitx.train")
    jax_ckpt.save_checkpoint(path, JaxState(params, stats, opt, 3))
    with open(path, "rb") as fh:
        raw = fh.read()
    assert packb(unpackb(raw), sort_keys=False) == raw
    assert port_ckpt.peek_step(path) == 3
    fresh = Trainer(cfg, device="cpu")
    fresh.state = port_ckpt.load_checkpoint(path, fresh.state)
    assert fresh.state.step == 3 and fresh.opt_state.count == 3
    want = flax_to_torch_state(jax.device_get(params), {})
    mu = flax_to_torch_state(jax.device_get(opt[1][0].mu), {})
    for n, p in fresh.state.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), want[n].numpy())
        np.testing.assert_array_equal(fresh.opt_state.mu[n].numpy(),
                                      mu[n].numpy())
    # a wrong architecture is refused by name
    other = Trainer(TrainConfig(imgsz=IMG, variant="n", segment=False,
                                nc=1), device="cpu")
    with pytest.raises(Exception, match="do not fit"):
        port_ckpt.load_checkpoint(path, other.state)


def test_deployment_files_cross_load(stepped, tmp_path):
    """A deployment file (params + batch stats + meta) written by the
    port's writer loads in eitx's segmenter, one written by flax in the
    port's; both label an image alike."""
    params, _ = torch_to_flax_tree(stepped.state.params)
    _, stats = torch_to_flax_tree(stepped.state.batch_stats)
    meta = {"variant": "n", "imgsz": IMG, "nc": 4, "steps": 2}
    payload = {"params": params, "batch_stats": stats, "meta": meta}
    port_path = str(tmp_path / "port.msgpack")
    flax_path = str(tmp_path / "flax.msgpack")
    from eitx_torch.models.yolo.checkpoint import write_msgpack_checkpoint

    write_msgpack_checkpoint(port_path, payload)
    with open(flax_path, "wb") as fh:
        fh.write(serialization.msgpack_serialize(payload))
    with open(port_path, "rb") as a, open(flax_path, "rb") as b:
        assert a.read() == b.read()
    assert port_convert.peek_checkpoint_meta(port_path) == meta
    state = port_convert.load_eitx_checkpoint(flax_path)
    for n, p in stepped.state.params.items():
        np.testing.assert_array_equal(state[n].numpy(), p.detach().numpy())
    jax_vars = jax_convert.load_eitx_checkpoint(port_path)
    assert set(jax_vars) == {"params", "batch_stats"}


def test_pt_reader_and_converter_on_synthetic_archives(tmp_path):
    """An ultralytics-shaped archive (a pickled fp16 module graph under
    'model', an 'ema' that wins) of a YOLOv11-n with the port's
    (= ultralytics') names: the port's reader equals eitx's, the
    converter fills the port's state dict name for name, and a runner
    built on the .pt computes what one built on the state computes."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        raw = YoloV11(yolov11_spec("n", nc=1, segment=False))
        ema = YoloV11(yolov11_spec("n", nc=1, segment=False))
    path = str(tmp_path / "ribs.pt")
    torch.save({"model": raw.half(), "ema": ema.half(), "epoch": 3,
                "train_args": {"imgsz": IMG}}, path)
    got = port_convert.load_torch_state(path)
    want = jax_convert.load_torch_state(path)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
        assert got[k].dtype == np.float32 or k.endswith("num_batches_tracked")
    ref = {k: v.float() for k, v in ema.state_dict().items()}
    for k, v in got.items():
        np.testing.assert_array_equal(v, ref[k].numpy())
    fresh = YoloV11(yolov11_spec("n", nc=1, segment=False))
    state = port_convert.convert_ultralytics_checkpoint(path, fresh)
    for k, v in state.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref[k]), k
    img = frontal_rib_phantom(np.random.default_rng(3), IMG)[0]
    det_pt = RibsDetector(weights=path, imgsz=IMG, variant="n", conf=0.0,
                          device="cpu").detect(img[None])
    runner = RibsDetector(imgsz=IMG, variant="n", conf=0.0, device="cpu")
    runner.model.load_state_dict(state)
    det = runner.detect(img[None])
    for a, b in zip(det_pt, det):
        np.testing.assert_array_equal(a, b)
    # a raw state dict with a tensor the model lacks is refused
    sd = dict(ema.state_dict())
    sd["model.99.conv.weight"] = torch.ones(2, 2)
    torch.save(sd, str(tmp_path / "bad.pt"))
    with pytest.raises(Exception, match="no destination"):
        port_convert.convert_ultralytics_checkpoint(str(tmp_path / "bad.pt"),
                                                    fresh)


class _Call:
    """Pickles as a call of ``fn(*args)`` at load time."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("protocol", [2, pickle.DEFAULT_PROTOCOL])
@pytest.mark.parametrize("fn", [exec, eval, os.system],
                         ids=["exec", "eval", "os.system"])
def test_pt_reader_runs_no_code_from_a_crafted_archive(fn, protocol,
                                                       tmp_path):
    """A .pt whose pickle calls exec / eval / os.system: nothing runs.
    The port's reader refuses ``builtins.exec`` (protocol 3 and up) and
    replaces every other module's name (``__builtin__.exec`` of protocol
    2, torch.save's, and ``posix.system``) by an inert stub; the runner's
    loader reports the checkpoint as unreadable."""
    marker = tmp_path / "ran"
    code = f"open({str(marker)!r}, 'w').close()"
    arg = f"touch {marker}" if fn is os.system else code
    path = tmp_path / "crafted.pt"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("crafted/data.pkl",
                    pickle.dumps({"model": _Call(fn, arg)}, protocol=protocol))
    if fn is os.system or protocol == 2:
        with pytest.raises(ModelError, match="no tensors"):
            port_convert.load_torch_state(str(path))
    else:
        with pytest.raises(pickle.UnpicklingError, match="builtins"):
            load_pt_archive(str(path))
        with pytest.raises(ModelError, match="cannot unpickle"):
            port_convert.load_torch_state(str(path))
    assert not marker.exists()


def test_merge_state_dict_matches_eitx():
    """Warm start of a proto-stride-2 graph from a stride-4 one: the same
    leaves copied and unused as eitx's merge on flax trees, and fresh the
    leaves under the module paths eitx leaves fresh (eitx names a missing
    module once, the flat state dict each of its tensors)."""
    s4 = YoloV11(yolov11_spec("n", proto_stride=4)).state_dict()
    s2 = YoloV11(yolov11_spec("n", proto_stride=2)).state_dict()

    def params(sd):
        return {k: v for k, v in sd.items()
                if not k.endswith(("running_mean", "running_var",
                                   "num_batches_tracked"))}

    merged, copied, skipped, unused = port_convert.merge_state_dict(
        params(s2), params(s4))
    jm, jc, js, ju = jax_convert.merge_state_dict(
        torch_to_flax_tree(params(s2))[0], torch_to_flax_tree(params(s4))[0])
    assert (len(copied), len(unused)) == (len(jc), len(ju))
    assert skipped and unused
    fresh = {"/".join(flax_path(k)[0]) for k in skipped}
    assert all(any(f.startswith(j.rsplit("/", 1)[0]) for j in js)
               for f in fresh)
    assert all(any(f.startswith(j.rsplit("/", 1)[0]) for f in fresh)
               for j in js)
    for k in copied:
        assert torch.equal(merged[k], s4[k])
    back = flax_to_torch_state(jm, {})
    for k, v in merged.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())


def _agreement(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).mean())


def test_train_tissue_main_checkpoint_labels_alike(tmp_path, record_property):
    """train_tissue at imgsz 64, variant n, 2 steps on the CPU: the
    .train file, the deployment file with its meta and the report; the
    deployment file labels a phantom alike through eitx's segmenter and
    the port's (float32, the quality composition)."""
    from eitx_torch.scripts.train_tissue import main

    out = str(tmp_path / "tissue.msgpack")
    report = main(["--steps", "2", "--batch", "2", "--imgsz", str(IMG),
                   "--variant", "n", "--n-train", "4", "--eval-n", "2",
                   "--out", out, "--device", "cpu",
                   "--report", str(tmp_path / "r.json")])
    assert os.path.exists(out + ".train") and os.path.exists(
        str(tmp_path / "r.json"))
    assert set(report) >= {"macro_iou", "per_class_iou",
                           "final_train_metrics", "wall_s"}
    assert port_ckpt.peek_step(out + ".train") == 2
    meta = port_convert.peek_checkpoint_meta(out)
    assert meta["steps"] == 2 and meta["imgsz"] == IMG
    assert meta["mask_res"] == IMG // 2 and meta["mask_topk"] == 160
    img = (phantom_batch(1, IMG, 12, np.random.default_rng(3))["images"][
        0, ..., 0] * 255).astype(np.uint8)
    kw = dict(imgsz=IMG, weights=out, variant="n", max_det=16, conf=0.0)
    want = EitxSegmenter(**kw).segment_labels(img[None], compose_full=True)
    got = TissueSegmenter(device="cpu", **kw).segment_labels(
        img[None], compose_full=True)
    bounded(record_property, "label agreement", _agreement(got, want), ">=",
            0.999)


def test_train_ribs_main_checkpoint_detects_alike(tmp_path, record_property):
    """train_ribs at imgsz 64, variant n, 2 steps on the CPU: its
    deployment file gives the same boxes through eitx's rib detector and
    the port's."""
    from eitx_torch.scripts.train_ribs import main

    out = str(tmp_path / "ribs.msgpack")
    report = main(["--steps", "2", "--batch", "2", "--imgsz", str(IMG),
                   "--variant", "n", "--n-train", "4", "--eval-n", "2",
                   "--out", out, "--device", "cpu"])
    assert "hard_distribution_eval" in report
    assert port_ckpt.peek_step(out + ".train") == 2
    assert port_convert.peek_checkpoint_meta(out)["nc"] == 1
    img = frontal_rib_phantom(np.random.default_rng(4), IMG)[0]
    kw = dict(weights=out, imgsz=IMG, variant="n", max_det=8, conf=0.0)
    want = EitxRibs(**kw).detect(img[None])
    got = RibsDetector(device="cpu", **kw).detect(img[None])
    np.testing.assert_array_equal(got.valid, np.asarray(want.valid))
    scale = max(float(np.abs(np.asarray(want.boxes)).max()), 1.0)
    bounded(record_property, "boxes, of scale", float(np.abs(
        got.boxes - np.asarray(want.boxes)).max()) / scale, "<=", 1e-4)
    bounded(record_property, "scores", float(np.abs(
        got.scores - np.asarray(want.scores)).max()), "<=", 1e-5)
