"""The port's trainer against eitx's: losses, assigners, anchors, the LR
schedule, clipping, AdamW, the EMA, BatchNorm's training update, the loss
on fixed network outputs in every configuration, and whole train steps of
the YOLOv11-n segmenter from the same initial parameters.

One JAX Trainer per module (imgsz 64, variant n, batch 2, the center
assigner so that every loss term has positives at initialisation). Its
initial parameters are carried into the port's Trainer through the
msgpack reader's mapping (HWIO -> OIHW)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from eitx.train import TrainConfig as JaxConfig
from eitx.train import Trainer as JaxTrainer
from eitx.train import synthetic_ct_batch
from eitx.train import losses as jax_losses
from eitx.train import trainer as jax_trainer
from eitx.train.checkpoint import save_checkpoint as jax_save_checkpoint
from eitx_torch.models.yolo.checkpoint import (
    flax_to_torch_state,
    torch_to_flax_tree,
)
from eitx_torch.models.yolo.resize import resize_bilinear
from eitx_torch.train import TrainConfig, Trainer, TrainState
from eitx_torch.train import losses as port_losses
from eitx_torch.train import trainer as port_trainer
from eitx_torch.train.checkpoint import load_checkpoint, peek_step
from torch_bounds import bounded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import digests_differ, state_digests  # noqa: E402

IMG = 64
CFG = dict(imgsz=IMG, variant="n", max_instances=4, total_steps=10,
           warmup_steps=0, lr=1e-4, assigner="center")
STATS = ("running_mean", "running_var")


def _rel_to_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _carry(tr: Trainer, params, batch_stats) -> None:
    """JAX variables -> the port's trainer (fresh optimizer state)."""
    st = flax_to_torch_state(jax.device_get(params),
                             jax.device_get(batch_stats))
    like = tr.state
    tr.state = TrainState(
        params={n: st[n] for n in like.params},
        batch_stats={n: st[n] for n in like.batch_stats},
        opt_state=tr.init_opt_state(), step=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The network's CPU steps on one thread: the parallel test workers
    share the cores, and torch's thread pools in every worker at once
    spin against each other."""
    # never set back above 1: a batched float32 linalg.solve (oneMKL)
    # later in the same worker can then hang
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_side():
    """The module's JAX Trainer, its compiled loss-and-gradient and its
    compiled optimizer update."""
    jt = JaxTrainer(JaxConfig(**CFG))
    vg = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))
    update = jax.jit(jt.tx.update)
    return jt, vg, update


def _jax_batch(batch):
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    b["valid"] = b["valid"].astype(jnp.float32)
    return b


def _port_trainer(jt, cfg=None) -> Trainer:
    tr = Trainer(TrainConfig(**(cfg or CFG)), device="cpu")
    _carry(tr, jt.state.params, jt.state.batch_stats)
    return tr


# --- losses, anchors, assigners ---------------------------------------------

def _boxes(rng, n, lo=0.0, hi=60.0):
    b = rng.uniform(lo, hi, (n, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(1.0, 30.0, (n, 2)).astype(np.float32)
    return b


@pytest.mark.parametrize("fn", ["ciou", "dfl_loss", "bce"])
def test_losses_match_eitx(fn, record_property):
    """Values and gradients within 1e-6 of their largest magnitude."""
    rng = np.random.default_rng(0)
    if fn == "ciou":
        args = [_boxes(rng, 300), _boxes(rng, 300)]
        args[1][:20] = args[0][:20]  # identical boxes: CIoU 1
        jf = jax_losses.ciou
        pf = port_losses.ciou
    elif fn == "dfl_loss":
        args = [rng.normal(size=(80, 4, 16)).astype(np.float32) * 3,
                rng.uniform(-1.0, 17.0, (80, 4)).astype(np.float32)]
        jf = lambda a, b: jax_losses.dfl_loss(a, b, 16)  # noqa: E731
        pf = lambda a, b: port_losses.dfl_loss(a, b, 16)  # noqa: E731
    else:
        args = [rng.normal(size=(500,)).astype(np.float32) * 8,
                rng.uniform(size=(500,)).astype(np.float32)]
        jf, pf = jax_losses.bce, port_losses.bce
    want = np.asarray(jf(*map(jnp.asarray, args)))
    want_g = np.asarray(jax.grad(lambda a: jf(a, jnp.asarray(args[1])).sum())(
        jnp.asarray(args[0])))
    x = torch.tensor(args[0], requires_grad=True)
    got = pf(x, torch.tensor(args[1]))
    got.sum().backward()
    bounded(record_property, f"{fn} value", _rel_to_max(got.detach(), want),
            "<=", 1e-6)
    bounded(record_property, f"{fn} gradient", _rel_to_max(x.grad, want_g),
            "<=", 1e-6)


def test_anchors_equal():
    for size in (64, 512, 640):
        pts, strd = jax_trainer._anchors_for(size)
        p, s = port_trainer._anchors_for(size)
        np.testing.assert_array_equal(p.numpy(), np.asarray(pts))
        np.testing.assert_array_equal(s.numpy(), np.asarray(strd))


def test_assigners_match_eitx(record_property):
    """Center and TAL assignment on random targets and predictions: the
    same target for every anchor, TAL's align within rtol 1e-5; a batch
    of images in one call equals the per-image calls."""
    rng = np.random.default_rng(3)
    anchors, strides = jax_trainer._anchors_for(IMG)
    a_t, s_t = port_trainer._anchors_for(IMG)
    A = anchors.shape[0]
    worst = 0.0
    per_image, batch = [], {"boxes": [], "classes": [], "valid": [],
                            "pred": [], "logits": []}
    for k in range(4):
        boxes = _boxes(rng, 5, 0.0, 40.0)
        classes = rng.integers(0, 4, 5).astype(np.int32)
        valid = (rng.random(5) < 0.8).astype(np.float32)
        pred = _boxes(rng, A, 0.0, 50.0)
        logits = rng.normal(size=(A, 4)).astype(np.float32) * 2
        want = np.asarray(jax_trainer._assign(anchors, strides,
                                              jnp.asarray(boxes),
                                              jnp.asarray(valid), 2.5))
        got = port_trainer._assign(a_t, s_t, torch.tensor(boxes),
                                   torch.tensor(valid), 2.5).numpy()
        np.testing.assert_array_equal(got, want)
        wa, wl = jax_trainer._assign_tal(
            anchors, jnp.asarray(pred), jnp.asarray(logits),
            jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid),
            10, 1.0, 6.0)
        ga, gl = port_trainer._assign_tal(
            a_t, torch.tensor(pred), torch.tensor(logits),
            torch.tensor(boxes), torch.tensor(classes), torch.tensor(valid),
            10, 1.0, 6.0)
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
        assert (ga.numpy() >= 0).any()
        wl = np.asarray(wl)
        worst = max(worst, float(np.abs(gl.numpy() - wl).max()
                                 / np.abs(wl).max()))
        per_image.append(ga)
        for key, v in zip(batch, (boxes, classes, valid, pred, logits)):
            batch[key].append(torch.tensor(v))
    bounded(record_property, "TAL align", worst, "<=", 1e-5)
    b = {k: torch.stack(v) for k, v in batch.items()}
    ga, _ = port_trainer._assign_tal(a_t, b["pred"], b["logits"], b["boxes"],
                                     b["classes"], b["valid"], 10, 1.0, 6.0)
    np.testing.assert_array_equal(ga.numpy(), torch.stack(per_image).numpy())


def test_proto_upsample_matches_jax_image_resize(record_property):
    """The mask loss upsamples the proto with the port's resize; it is
    jax.image.resize(..., "bilinear")."""
    rng = np.random.default_rng(4)
    p = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    for size in (32, 64):
        want = np.asarray(jax.image.resize(jnp.asarray(p), (2, size, size, 32),
                                           "bilinear"))
        got = resize_bilinear(torch.tensor(p).permute(0, 3, 1, 2), size,
                               size).permute(0, 2, 3, 1).numpy()
        bounded(record_property, f"resize to {size}", _rel_to_max(got, want),
                "<=", 1e-6)


# --- optimizer, schedule, EMA, BatchNorm ------------------------------------

@pytest.mark.parametrize("warmup,total", [(5, 20), (0, 13), (100, 1200)])
def test_lr_schedule_matches_optax(warmup, total, record_property):
    """The LR at every count from 0 past total_steps, eager and as the
    compiled step reads it (XLA may fuse the float32 steps: one rounding
    apart at most)."""
    cfg = TrainConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    at = port_trainer.lr_schedule(cfg)
    sched = optax.warmup_cosine_decay_schedule(0.0, cfg.lr, warmup, total)
    compiled = jax.jit(sched)
    counts = np.arange(total + 3, dtype=np.int32)
    got = np.asarray([at(c) for c in counts])
    for name, fn in (("eager", sched), ("compiled", compiled)):
        want = np.asarray([float(fn(jnp.int32(c))) for c in counts])
        bounded(record_property, f"lr {name}",
                np.abs(got - want).max() / cfg.lr, "<=", 1e-6)
    if warmup:
        assert got[0] == 0.0  # the first step of a warmup has lr 0


@pytest.mark.parametrize("scale", [0.01, 30.0])
def test_clip_by_global_norm_matches_optax(scale, record_property):
    rng = np.random.default_rng(5)
    g = [rng.normal(size=s).astype(np.float32) * scale
         for s in ((3, 4), (7,), (2, 2, 3, 3))]
    tx = optax.clip_by_global_norm(10.0)
    want, _ = tx.update(g, tx.init(g))
    got = port_trainer.clip_by_global_norm([torch.tensor(x) for x in g], 10.0)
    err = max(_rel_to_max(t, w) for t, w in zip(got, want))
    bounded(record_property, f"clip at scale {scale}", err, "<=", 1e-6)
    if scale < 1:  # below the bound: untouched
        assert all(np.array_equal(t.numpy(), x) for t, x in zip(got, g))


def test_adamw_update_matches_optax(record_property):
    """Three optimizer steps of the port (clip, adam, decoupled decay of
    every parameter, the schedule at the count before the increment) on
    the network's parameters against optax's chain on the same tree."""
    cfg = TrainConfig(imgsz=IMG, variant="n", warmup_steps=2, total_steps=9,
                      lr=2e-3, weight_decay=5e-2)
    tr = Trainer(cfg, device="cpu")
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, cfg.lr, cfg.warmup_steps,
                                           cfg.total_steps),
        weight_decay=cfg.weight_decay))
    params, _ = torch_to_flax_tree(tr.state.params)
    opt = tx.init(params)
    rng = np.random.default_rng(6)
    worst = 0.0
    update = jax.jit(tx.update)
    for step in range(3):
        grads = {n: torch.tensor(rng.normal(size=tuple(p.shape)).astype(
            np.float32) * (0.01 if step == 1 else 1.0))
            for n, p in tr.state.params.items()}
        for n, p in tr.state.params.items():
            p.grad = grads[n]
        tr._apply_updates()
        upd, opt = update(torch_to_flax_tree(grads)[0], opt, params)
        params = jax.jit(optax.apply_updates)(params, upd)
        want = flax_to_torch_state(jax.device_get(params), {})
        worst = max(worst, max(_rel_to_max(p.detach(), want[n])
                               for n, p in tr.state.params.items()))
    assert tr.opt_state.count == 3
    bounded(record_property, "params after 3 adamw steps", worst, "<=", 1e-6)


def test_ema_matches_eitx(record_property):
    rng = np.random.default_rng(7)
    p0 = {"a": rng.normal(size=(3, 5)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    jema = jax_trainer.EMA(p0, 0.999, tau=3.0)
    pema = port_trainer.EMA({k: torch.tensor(v) for k, v in p0.items()},
                            0.999, tau=3.0)
    for _ in range(6):
        p = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p0.items()}
        jema.update(p)
        pema.update({k: torch.tensor(v) for k, v in p.items()})
    err = max(_rel_to_max(pema.params[k], np.asarray(jema.params[k]))
              for k in p0)
    bounded(record_property, "EMA after 6 updates", err, "<=", 1e-6)


def test_batchnorm_training_update_is_flax(record_property):
    """flax's BatchNorm(momentum 0.97, eps 1e-3) moves its running
    variance by the biased batch variance; torch's BatchNorm2d by the
    unbiased one with momentum 0.1. The port's training update is flax's
    (n = 8 per channel: the P5 level at imgsz 64, batch 2)."""
    import flax.linen as nn

    from eitx_torch.models.yolo.blocks import BatchNorm2d

    rng = np.random.default_rng(8)
    x = rng.normal(1.0, 2.0, (2, 2, 2, 6)).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)
    variables = bn.init(jax.random.PRNGKey(0), x)
    y, mutated = bn.apply(variables, x, mutable=["batch_stats"])
    port = BatchNorm2d(6).train()
    got = port(torch.tensor(x).permute(0, 3, 1, 2))
    bounded(record_property, "output", _rel_to_max(
        got.detach().permute(0, 2, 3, 1), np.asarray(y)), "<=", 1e-6)
    want = mutated["batch_stats"]
    bounded(record_property, "running_var", _rel_to_max(
        port.running_var, np.asarray(want["var"])), "<=", 1e-6)
    bounded(record_property, "running_mean", _rel_to_max(
        port.running_mean, np.asarray(want["mean"])), "<=", 1e-6)
    plain = torch.nn.BatchNorm2d(6, eps=1e-3).train()
    plain(torch.tensor(x).permute(0, 3, 1, 2))
    assert _rel_to_max(plain.running_var, np.asarray(want["var"])) > 1e-2


# --- the loss on fixed network outputs --------------------------------------

class _Outputs:
    """A stand-in for eitx's flax network whose 'parameters' are its raw
    outputs: eitx's own loss then runs on given head maps, and its
    gradient is the gradient with respect to them."""

    @staticmethod
    def apply(variables, images, train, mutable):
        return variables["params"], {"batch_stats": {}}


def _random_outputs(rng, nc, segment, proto, B=2):
    """NHWC head maps at imgsz 64; the DFL logits favour short distances
    so that predicted boxes overlap the targets."""
    bins = np.linspace(2.0, -2.0, 16, dtype=np.float32)
    levels = []
    for n in (8, 4, 2):
        bm = rng.normal(size=(B, n, n, 4, 16)).astype(np.float32) + bins
        cm = rng.normal(size=(B, n, n, nc)).astype(np.float32) - 1.0
        levels.append((bm.reshape(B, n, n, 64), cm))
    out = {"levels": levels}
    if segment:
        out["mask_coefs"] = [rng.normal(size=(B, n, n, 32)).astype(np.float32)
                             for n in (8, 4, 2)]
        out["proto"] = rng.normal(size=(B, proto, proto, 32)).astype(
            np.float32)
    return out


LOSS_CASES = {
    "tal": dict(assigner="tal"),
    "tal_mask_topk": dict(assigner="tal", mask_topk=8),
    "mask_class_w": dict(mask_class_w=(1.5, 0.8, 0.8, 1.6)),
    "center_mask_topk_upsampled": dict(mask_topk=12, mask_res=32),
    "segment_false": dict(segment=False, nc=1),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_on_fixed_outputs_matches_eitx(case, record_property):
    """eitx's loss and the port's on the same head maps: every component
    within rtol 1e-5, the gradient with respect to every map within 1e-5
    of its largest magnitude. Covers TAL, the top-K mask gather (a stable
    sort for top_k), per-class mask weights, the proto upsampled to the
    mask resolution, and the detect-only head."""
    kw = dict(CFG)
    kw.update(LOSS_CASES[case])
    mask_res = kw.pop("mask_res", None)
    cfg_j, cfg_p = JaxConfig(**kw), TrainConfig(**kw)
    rng = np.random.default_rng(9)
    batch = synthetic_ct_batch(2, IMG, 4, seed=2)
    if mask_res:
        batch["masks"] = batch["masks"].repeat(2, 2).repeat(2, 3)
    if not cfg_p.segment:
        batch["classes"][:] = 0
    out = _random_outputs(rng, cfg_p.nc, cfg_p.segment, IMG // 4)
    jt = object.__new__(JaxTrainer)
    jt.cfg, jt.model = cfg_j, _Outputs
    jt.anchors, jt.strides = jax_trainer._anchors_for(IMG)
    (_, (_, want)), want_g = jax.jit(jax.value_and_grad(
        jt._loss_fn, has_aux=True))(out, {}, _jax_batch(batch))
    tr = Trainer(cfg_p, device="cpu")

    def nchw(a):
        return torch.tensor(a).permute(0, 3, 1, 2).requires_grad_(True)

    t_out = {"levels": [(nchw(b), nchw(c)) for b, c in out["levels"]]}
    if cfg_p.segment:
        t_out["mask_coefs"] = [nchw(m) for m in out["mask_coefs"]]
        t_out["proto"] = nchw(out["proto"])
    loss, got = tr._loss_from_outputs(t_out, tr._device_batch(batch))
    loss.backward()
    for k, v in want.items():
        v = float(v)
        bounded(record_property, f"{k}", abs(float(got[k]) - v)
                / max(abs(v), 1e-30), "<=", 1e-5)
        if k != "mask" or cfg_p.segment:
            assert v > 0.0, f"{k} is zero: the case tests nothing"
    pairs = [(t_out["levels"][i][j], want_g["levels"][i][j])
             for i in range(3) for j in range(2)]
    if cfg_p.segment:
        pairs += [(t_out["mask_coefs"][i], want_g["mask_coefs"][i])
                  for i in range(3)]
        pairs.append((t_out["proto"], want_g["proto"]))
    err = max(_rel_to_max(t.grad.permute(0, 2, 3, 1), np.asarray(w))
              for t, w in pairs)
    bounded(record_property, "gradient", err, "<=", 1e-5)


# --- whole train steps of the network ---------------------------------------

def test_one_step_loss_gradients_and_batch_stats_match_eitx(
        jax_side, record_property):
    """One batch through the whole network from eitx's initial parameters.
    Float32 over BatchNorm statistics of 8 values (the P5 level) leaves
    both packages ~1e-3 of a gradient's scale from float64 (worst leaf:
    eitx's 5.5e-3, the port's 1.0e-3 on this batch, each against the
    port in float64), so the gradient bound is per leaf against its own
    largest magnitude, leaves whose gradient is zero in exact arithmetic
    (eitx's largest below 1e-6 of the largest of all) left out. The
    running statistics after the step are held to their overall scale:
    eitx's are 4.5e-4 of a P5 leaf's own largest from float64, the
    port's 1.4e-4."""
    jt, vg, _ = jax_side
    batch = synthetic_ct_batch(2, IMG, 4, seed=1)
    (_, (new_stats, want)), grads = vg(jt.state.params, jt.state.batch_stats,
                                       _jax_batch(batch))
    tr = _port_trainer(jt)
    loss, got = tr._loss(tr._device_batch(batch))
    loss.backward()
    for k, v in want.items():
        bounded(record_property, f"{k}", abs(float(got[k]) - float(v))
                / abs(float(v)), "<=", 1e-5)
    g_want = flax_to_torch_state(jax.device_get(grads), {})
    top = max(float(np.abs(np.asarray(g)).max()) for g in g_want.values())
    errs = [_rel_to_max(p.grad, g_want[n])
            for n, p in tr.state.params.items()
            if np.abs(g_want[n].numpy()).max() > 1e-6 * top]
    assert len(errs) > 0.8 * len(g_want)
    bounded(record_property, "gradient, worst leaf", max(errs), "<=", 2e-2)
    bounded(record_property, "gradient, median leaf", float(np.median(errs)),
            "<=", 5e-3)
    s_want = flax_to_torch_state({}, jax.device_get(new_stats))
    scale = max(float(np.abs(s.numpy()).max()) for s in s_want.values())
    err = max(float(np.abs(t.numpy() - s_want[n].numpy()).max())
              for n, t in tr.state.batch_stats.items()) / scale
    bounded(record_property, "batch_stats after one step, of scale", err,
            "<=", 5e-5)


def _jax_steps(jt, vg, update, batches):
    """eitx's steps on ``batches``: the final state, each step's metrics,
    and the first step's gradients and updates."""
    params, stats, opt = jt.state.params, jt.state.batch_stats, jt.tx.init(
        jt.state.params)
    metrics, first = [], None
    for b in batches:
        (_, (stats, m)), g = vg(params, stats, _jax_batch(b))
        upd, opt = update(g, opt, params)
        first = first or (g, upd)
        params = optax.apply_updates(params, upd)
        metrics.append({k: float(v) for k, v in m.items()})
    return params, stats, opt, metrics, first


def test_train_steps_match_eitx(jax_side, record_property, tmp_path):
    """Three optimizer steps of each package from the same parameters and
    batches. The first step's updates are ~lr * sign(g): compared where
    |g| is above 0.1 of its leaf's largest (the sign is not in doubt
    there), in units of lr. Where |g| is at its float32 noise the two
    first updates take opposite signs, 2 lr apart, so the loss components
    of steps 2-3 are held to a measured bound. Then a JAX ``.train`` file
    of step 3 resumes in the port: the fourth step's loss is eitx's from
    the same parameters (the mask term 2.2e-5 apart there)."""
    jt, vg, update = jax_side
    batches = [synthetic_ct_batch(2, IMG, 4, seed=s) for s in (1, 2, 3, 4)]
    params, stats, opt, want, (g0, u0) = _jax_steps(jt, vg, update,
                                                    batches[:3])
    tr = _port_trainer(jt)
    p0 = {n: p.detach().clone() for n, p in tr.state.params.items()}
    got = [tr.train_step(batches[0])]
    g0 = flax_to_torch_state(jax.device_get(g0), {})
    d_want = flax_to_torch_state(jax.device_get(u0), {})
    worst, n_cmp = 0.0, 0
    top = max(float(np.abs(g.numpy()).max()) for g in g0.values())
    for n, p in tr.state.params.items():
        g = np.abs(g0[n].numpy())
        if g.max() <= 1e-6 * top:  # zero in exact arithmetic: noise
            continue
        big = g > 0.1 * g.max()
        d = (p.detach() - p0[n]).numpy()[big]
        worst = max(worst, float(np.abs(d - d_want[n].numpy()[big]).max(
            initial=0.0)) / CFG["lr"])
        n_cmp += int(big.sum())
    assert n_cmp > 1000
    bounded(record_property, "first update, in units of lr", worst, "<=",
            2e-3)
    got += [tr.train_step(b) for b in batches[1:3]]
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            bound = 1e-5 if step == 0 else 5e-3
            bounded(record_property, f"step {step + 1} {k}",
                    abs(g[k] - w[k]) / abs(w[k]), "<=", bound)
    # resume from eitx's .train of step 3
    from eitx.train.trainer import TrainState as JaxState

    path = str(tmp_path / "jax.train")
    jax_save_checkpoint(path, JaxState(params, stats, opt, 3))
    assert peek_step(path) == 3
    fresh = Trainer(TrainConfig(**CFG), device="cpu")
    fresh.state = load_checkpoint(path, fresh.state)
    assert fresh.state.step == 3 and fresh.opt_state.count == 3
    nxt = fresh.train_step(batches[3])
    (_, (_, m)), _ = vg(params, stats, _jax_batch(batches[3]))
    for k, v in m.items():
        bounded(record_property, f"resumed step 4 {k}",
                abs(nxt[k] - float(v)) / abs(float(v)), "<=", 1e-4)


INIT_SPECS = {
    "segment_stride4": dict(variant="n", proto_stride=4),
    "segment_stride2": dict(variant="n", proto_stride=2),
    "ribs": dict(variant="n", nc=1, segment=False, max_instances=24),
}


@pytest.mark.parametrize("name,seed", [("segment_stride4", 0),
                                       ("segment_stride2", 5), ("ribs", 2)])
def test_trainer_init_matches_eitx(name, seed):
    """``Trainer(cfg, seed)`` starts from eitx's ``Trainer(cfg, seed)``: every
    parameter and batch statistic equal on every bit (flax's keys and
    XLA:CPU's truncated normal, tests/test_torch_prng.py), for the
    segmenter at both proto strides and the rib detector."""
    kw = dict(imgsz=IMG, **INIT_SPECS[name])
    jt = JaxTrainer(JaxConfig(**kw), seed=seed)
    tr = Trainer(TrainConfig(**kw), seed=seed, device="cpu")
    want = flax_to_torch_state(jax.device_get(jt.state.params),
                               jax.device_get(jt.state.batch_stats))
    got = {**tr.state.params, **tr.state.batch_stats}
    assert set(got) == set(want)
    for n, t in got.items():
        np.testing.assert_array_equal(t.detach().numpy().view(np.uint32),
                                      want[n].numpy().view(np.uint32),
                                      err_msg=n)


def test_fit_from_seed_matches_eitx(record_property):
    """Three steps of ``fit`` from seed 3 in each package: each its own
    trainer and its own ``device_batches`` stream over one store, nothing
    carried from one to the other. The same seed gives the same initial
    parameters and batches, so the steps are held to
    test_train_steps_match_eitx's bounds: 1e-5 for the first step's loss
    components, 5e-3 after (Adam's first update is ~lr * sign(g), and
    where g is float32 noise the two packages' signs differ). The first
    step's mask term is the exception: on a random network its float32
    value is ill-conditioned (mask logits that cancel in the coefficient
    product), and on this stream's first batch eitx's is 1.1e-5 and the
    port's 3.6e-5 from the port's float64 step (on the stream's sixth
    batch 7.3e-4 and 1.8e-4), so the two are held to 1e-4 there."""
    from eitx.train.data import device_batches as jax_stream
    from eitx.train.trainer import fit as jax_fit
    from eitx_torch.train.data import device_batches as port_stream
    from eitx_torch.train.trainer import fit as port_fit

    store = synthetic_ct_batch(6, IMG, 4, seed=7)
    store["images"] = np.round(store["images"] * 255).astype(np.uint8)
    store["masks"] = np.round(store["masks"] * 255).astype(np.uint8)
    seed = 3
    jt = JaxTrainer(JaxConfig(**CFG), seed=seed)
    tr = Trainer(TrainConfig(**CFG), seed=seed, device="cpu")
    want_it = jax_stream(store, 2, seed=seed)
    got_it = port_stream(store, 2, seed=seed, device="cpu")
    for step in range(3):
        want, _ = jax_fit(jt, want_it, 1, log_every=0)
        got, _ = port_fit(tr, got_it, 1, log_every=0)
        for k in want:
            bound = 5e-3 if step else 1e-4 if k == "mask" else 1e-5
            bounded(record_property, f"step {step + 1} {k}",
                    abs(got[k] - want[k]) / abs(want[k]), "<=", bound)


def test_uint8_batches_scale_as_eitx_step():
    """A uint8 batch enters the step as eitx's compiled step scales it:
    XLA turns x / 255 into x times the float32 reciprocal, which differs
    from a division on half the grey levels."""
    x = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax.jit(lambda a: a.astype(jnp.float32) / 255.0)(x))
    tr = Trainer(TrainConfig(**CFG), device="cpu")
    got = (torch.from_numpy(x).to(torch.float32) * tr._inv255).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_trainer_refuses_a_mesh():
    """A mesh is a DeviceMesh of eitx_torch.parallel (the sharded step is
    tests/test_torch_parallel.py's); anything else raises before a step."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(TrainConfig(imgsz=IMG, variant="n"), mesh=object(),
                device="cpu")
    if not torch.cuda.is_available():  # the default is the card, or raise
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(TrainConfig(imgsz=IMG, variant="n"))


def test_fit_loop_with_ema_and_checkpoint(tmp_path):
    """tests/test_train.py's fit test on the port: finite metrics, the
    checkpoint written, EMA params that track but differ from the raw
    ones, and eval_loss leaving the running statistics as they were."""
    from eitx_torch.train.data import synthetic_ct_batch as port_batch
    from eitx_torch.train.trainer import fit

    tr = Trainer(TrainConfig(imgsz=IMG, variant="n", total_steps=6,
                             warmup_steps=0, max_instances=4), device="cpu")

    def batches():
        i = 0
        while True:
            yield port_batch(batch=2, imgsz=IMG, max_instances=4, seed=i)
            i += 1

    ckpt = str(tmp_path / "fit.msgpack.train")
    val = port_batch(batch=2, imgsz=IMG, max_instances=4, seed=99)
    metrics, ema = fit(tr, batches(), steps=4, log_every=0,
                       checkpoint_path=ckpt, checkpoint_every=2,
                       val_batch=val, val_every=2)
    assert np.isfinite(metrics["loss"]) and "val_loss" in metrics
    assert peek_step(ckpt) == 4
    assert any(not torch.allclose(ema[n], p)
               for n, p in tr.state.params.items())
    before = [t.clone() for t in tr.state.batch_stats.values()]
    tr.eval_loss(val)
    assert all(torch.equal(a, b) for a, b in
               zip(before, tr.state.batch_stats.values()))


# --- the same seed, the same run ---------------------------------------------

# the train phase's assigner and mask selection at the module's size
REPRO_CFG = dict(CFG, assigner="tal", mask_topk=16)


def _three_batches():
    """The first 3 batches of one seeded ``device_batches`` stream."""
    from eitx_torch.train.data import device_batches
    from eitx_torch.train.data import synthetic_ct_batch as port_batch

    store = port_batch(6, IMG, 4, seed=7)
    store["images"] = np.round(store["images"] * 255).astype(np.uint8)
    store["masks"] = np.round(store["masks"] * 255).astype(np.uint8)
    stream = device_batches(store, 2, seed=0, device="cpu")
    return [next(stream) for _ in range(3)]


def test_trainers_from_one_seed_give_one_run():
    """Two trainers from one seed, each given the same 3 batches of one
    ``device_batches`` stream through ``fit``: the metrics and every
    parameter, batch statistic, Adam moment and EMA leaf equal to the bit,
    as two runs of eitx from one seed are."""
    from eitx_torch.train.trainer import fit

    batches = _three_batches()
    runs = []
    for _ in range(2):
        tr = Trainer(TrainConfig(**REPRO_CFG), seed=0, device="cpu")
        metrics, ema = fit(tr, iter(batches), 3, log_every=0)
        runs.append((metrics, state_digests(tr, ema)))
    (m_a, a), (m_b, b) = runs
    assert m_a == m_b
    assert sum(n.startswith("ema/") for n in a) == len(tr.state.params)
    assert digests_differ(a, b) == []


def test_resumed_run_equals_the_uninterrupted_run(tmp_path):
    """A run saved after step 2 and resumed from its ``.train`` file into a
    trainer built from another seed equals the uninterrupted run after
    step 3, on every leaf of state and on the metrics."""
    from eitx_torch.train.checkpoint import save_checkpoint

    cfg = TrainConfig(**REPRO_CFG)
    batches = _three_batches()
    whole = Trainer(cfg, seed=0, device="cpu")
    part = Trainer(cfg, seed=0, device="cpu")
    for b in batches[:2]:
        whole.train_step(b)
        part.train_step(b)
    path = str(tmp_path / "part.train")
    save_checkpoint(path, part.state)
    resumed = Trainer(cfg, seed=7, device="cpu")
    resumed.state = load_checkpoint(path, resumed.state)
    assert resumed.train_step(batches[2]) == whole.train_step(batches[2])
    assert (resumed.state.step, resumed.opt_state.count) == (3, 3)
    assert digests_differ(state_digests(resumed), state_digests(whole)) == []


def test_mesh_of_one_equals_meshless_to_the_bit(tmp_path):
    """Three steps on a (data, model) = (1, 1) gloo mesh against the
    meshless trainer from the same seed and batches: the metrics of every
    step and every leaf of state after each equal to the bit (a group of
    one computes the single-device step; chip_smoke.py holds the NCCL
    mesh on the card to the same)."""
    import torch.distributed as dist

    from eitx_torch.parallel import init_distributed, make_device_mesh

    cfg = TrainConfig(**REPRO_CFG)
    batches = _three_batches()
    init_distributed(0, 1, str(tmp_path / "store"), "cpu")
    try:
        mesh = make_device_mesh(("data", "model"), (1, 1), device_type="cpu")
        plain = Trainer(cfg, seed=0, device="cpu")
        sharded = Trainer(cfg, mesh=mesh, seed=0, device="cpu")
        for b in batches:
            assert sharded.train_step(b) == plain.train_step(b)
            assert digests_differ(state_digests(sharded),
                                  state_digests(plain)) == []
    finally:
        dist.destroy_process_group()


def test_importing_the_port_sets_deterministic_cudnn_once():
    """Importing ``eitx_torch`` switches TF32 off and cuDNN to its
    deterministic algorithms (benchmarking off), once for the process, and
    leaves torch's process-wide deterministic mode off: that mode fills
    every ``torch.empty`` (the pip kernel's scratch) and refuses a
    float32 ``cumsum`` on the card."""
    code = (
        "import json, torch\n"
        "def read():\n"
        "    b = torch.backends\n"
        "    return dict(deterministic=b.cudnn.deterministic,\n"
        "                benchmark=b.cudnn.benchmark,\n"
        "                cudnn_tf32=b.cudnn.allow_tf32,\n"
        "                matmul_tf32=b.cuda.matmul.allow_tf32,\n"
        "                algorithms=torch."
        "are_deterministic_algorithms_enabled())\n"
        "before = read()\n"
        "import eitx_torch\n"
        "print(json.dumps([before, read()]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    before, after = json.loads(out.stdout.strip().splitlines()[-1])
    assert before["deterministic"] is False  # torch's default
    assert after == dict(deterministic=True, benchmark=False,
                         cudnn_tf32=False, matmul_tf32=False,
                         algorithms=False)
