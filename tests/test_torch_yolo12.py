"""YOLO12 in the port (``models/yolo/blocks.py`` ``AAttn``, ``ABlock``,
``A2C2f``; ``model.py`` ``YoloV12``; ``init.py``; ``TrainConfig.arch``)
against the benchmark's plain reference (``benchmark/reference/yolo12``),
which imports nothing of the port: its areas are an explicit loop over
stripes of rows, its layers ``F.conv2d`` / ``F.batch_norm`` / matmul and
softmax. eitx has no YOLO12, so no JAX network takes part.

Where the two differ it is float32 rounding: both train BatchNorm by
torch's fused batch norm, but the attention's and the head's products
are summed in other orders, and a 64-128 px map leaves BatchNorm few
values at P5 (8-32 at 64 px, batch 2), so their gap grows through the
~130 BatchNorms of the network. In float64 the two networks agree to
1e-13 of their outputs' scale."""

import collections
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from eitx_torch.core import timing
from eitx_torch.models.yolo.blocks import A2C2f, AAttn, ABlock, BatchNorm2d
from eitx_torch.models.yolo.init import torch_init_state, yolo12_init_model
from eitx_torch.models.yolo.model import YoloV12, yolov12_spec
from eitx_torch.train import TrainConfig, Trainer, synthetic_ct_batch
from eitx_torch.train.checkpoint import load_checkpoint, save_checkpoint
from torch_bounds import bounded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from benchmark.reference.yolo12 import model as ref_model  # noqa: E402
from benchmark.reference.yolo12 import trainer as ref_trainer  # noqa: E402

IMG = 64
STEP_CFG = dict(imgsz=IMG, max_instances=4, total_steps=10, warmup_steps=0,
                lr=1e-4, assigner="center")
# a first gradient under this share of the median leaf's is rounding: a
# per-channel constant (a BatchNorm's bias on a residual branch) that the
# next training BatchNorm takes out, whose exact gradient is 0
DEAD_LEAF = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The network's CPU steps on one thread: the parallel test workers
    share the cores."""
    # never set back above 1: a batched float32 linalg.solve (oneMKL)
    # later in the same worker can then hang
    torch.set_num_threads(1)


def _of_scale(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _outputs(out) -> list:
    flat = [t for level in out["levels"] for t in level]
    return flat + list(out.get("mask_coefs") or []) + (
        [out["proto"]] if "proto" in out else [])


# -- area attention ------------------------------------------------------
@pytest.mark.parametrize("area,shape", [(1, (8, 6)), (4, (8, 6)),
                                        (2, (4, 10))])
def test_area_attention_matches_reference(area, shape, record_property):
    """AAttn on a map whose stripes differ (each stripe of rows offset by
    its own constant), against the reference's loop over stripes: within
    1e-5 of the output's scale (float32 products summed in other orders;
    measured ~4e-7)."""
    torch.manual_seed(area)
    port = AAttn(64, 2, area).train()
    ref = ref_model.AAttn(64, 2, area).train()
    ref.load_state_dict(port.state_dict())
    x = torch.randn(2, 64, *shape)
    rows = shape[0] // area
    for s in range(area):
        x[:, :, s * rows:(s + 1) * rows] += 2.0 * s
    with torch.no_grad():
        got, want = port(x), ref(x)
    bounded(record_property, "AAttn, of scale", _of_scale(got, want), "<=",
            1e-5)
    if area > 1:  # the stripes matter: attending over the whole map differs
        port.area = 1
        with torch.no_grad():
            assert _of_scale(port(x), want) > 1e-2


def test_area_attention_refuses_a_map_of_broken_areas():
    with pytest.raises(ValueError, match="areas"):
        AAttn(32, 1, 4)(torch.randn(1, 32, 3, 3))


# -- the network ---------------------------------------------------------
@pytest.mark.parametrize("variant,imgsz,proto_stride",
                         [("n", 128, 4), ("n", 128, 2), ("l", 64, 4),
                          ("l", 64, 2)])
def test_yolov12_forward_matches_reference(variant, imgsz, proto_stride,
                                           record_property):
    """The whole network in training mode (batch statistics) on seeded
    random weights: every output map within 5e-4 of its scale. Rounding
    alone, grown through the network's BatchNorms: 1.1e-5 - 1.7e-5
    measured (the module docstring)."""
    spec = yolov12_spec(variant, nc=4, proto_stride=proto_stride)
    port = yolo12_init_model(spec, seed=7).train()
    ref = ref_model.YoloV12(variant, 4, True, proto_stride).train()
    ref.load_state_dict(port.state_dict())
    x = torch.rand(2, 3, imgsz, imgsz, generator=torch.Generator()
                   .manual_seed(1))
    with torch.no_grad():
        got, want = port(x), ref(x)
    assert got["strides"] == want["strides"]
    assert got["proto"].shape[-1] == imgsz // proto_stride
    err = max(_of_scale(a, b) for a, b in zip(_outputs(got), _outputs(want)))
    bounded(record_property, "YoloV12 outputs, of scale", err, "<=", 5e-4)


def _step_pair(variant: str, seed: int):
    """A port Trainer and the reference trainer from the port's initial
    state, each after one step on the same batch."""
    cfg = dict(STEP_CFG, variant=variant)
    port = Trainer(TrainConfig(arch="yolo12", **cfg), seed=seed,
                   device="cpu")
    ref = ref_trainer.Trainer(ref_trainer.TrainConfig(**cfg), device="cpu")
    st = port.state
    ref.state = ref_trainer.TrainState(
        params={n: t.detach().clone() for n, t in st.params.items()},
        batch_stats={n: t.clone() for n, t in st.batch_stats.items()},
        opt_state=ref.init_opt_state(), step=0)
    theta0 = {n: t.detach().clone() for n, t in st.params.items()}
    batch = synthetic_ct_batch(2, IMG, 4, seed=seed + 10)
    return port, ref, theta0, port.train_step(batch), ref.train_step(batch)


@pytest.mark.parametrize("variant", ["n", "l"])
def test_trainer_step_matches_reference(variant, record_property):
    """One ``Trainer(arch="yolo12")`` step (center assigner, so every loss
    term has positives at initialisation) against the reference trainer:
    each loss term within 1e-4 relative (measured <= 2.4e-6); every
    gradient leaf within 5e-3 of its norm (rounding through BatchNorm over
    few values, ~1e-3 of a leaf at 64 px as for YOLOv11; measured
    <= 1.8e-4) or, for the leaves whose exact gradient is 0
    (``DEAD_LEAF``), small on both sides. The update is AdamW's first
    step, ~lr * sign(g): an element whose gradient is rounding may flip
    its sign and move by 2 lr, so at most 1e-3 of the elements may differ by more than lr (measured
    <= 2.2e-6), and on the elements of live leaves whose gradient is at
    least 1e-2 of the leaf's largest the two updates agree within 5e-2 lr
    (measured 1.2e-3 lr: the rounding of theta + update)."""
    port, ref, theta0, m_port, m_ref = _step_pair(variant, seed=0)
    loss_rel = max(abs(m_port[k] - m_ref[k]) / max(abs(m_ref[k]), 1e-30)
                   for k in m_ref)
    bounded(record_property, "loss terms, relative", loss_rel, "<=", 1e-4)
    g_port = dict(zip(port._names, [p.grad for p in port._params]))
    g_ref = dict(zip(ref._names, [p.grad for p in ref._params]))
    assert set(g_port) == set(g_ref)
    norms = {n: float(g.norm()) for n, g in g_ref.items()}
    med = float(np.median(list(norms.values())))
    live = [n for n in norms if norms[n] >= DEAD_LEAF * med]
    dead = [n for n in norms if n not in live]
    assert len(live) > 0.8 * len(norms)
    grad_gap = max(float((g_port[n] - g_ref[n]).norm()) / norms[n]
                   for n in live)
    bounded(record_property, "live gradient leaves, of norm", grad_gap, "<=",
            5e-3)
    for n in dead:
        assert float(g_port[n].norm()) < 10 * DEAD_LEAF * med, n
    lr, flipped, total, clear_gap = STEP_CFG["lr"], 0, 0, 0.0
    for n, g in g_ref.items():
        d = ((port.state.params[n] - theta0[n])
             - (ref.state.params[n] - theta0[n])).detach().abs()
        flipped += int((d > lr).sum())
        total += d.numel()
        clear = g.abs() >= 1e-2 * g.abs().max()
        if n in live:
            clear_gap = max(clear_gap, float(d[clear].max()) / lr)
    bounded(record_property, "update, share of elements flipped", flipped
            / total, "<=", 1e-3)
    bounded(record_property, "update of clear elements, of lr", clear_gap,
            "<=", 5e-2)


# -- BatchNorm -----------------------------------------------------------
def _batchnorm_run(x, g, fused):
    """Output, gradients of input, scale and bias, running mean and
    variance of one training BatchNorm2d(16) step in x's dtype."""
    bn = BatchNorm2d(16).to(x.dtype).train()
    bn.fused = fused
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 16))
        bn.bias.copy_(torch.linspace(-1.0, 1.0, 16))
    xi = x.clone().requires_grad_(True)
    y = bn(xi)
    y.backward(g)
    return (y.detach(), xi.grad, bn.weight.grad, bn.bias.grad,
            bn.running_mean.clone(), bn.running_var.clone())


@pytest.mark.parametrize("shift", [0.0, 30.0])
def test_fused_batchnorm_is_flax_batchnorm(shift, record_property):
    """YOLO12's fused training BatchNorm against flax's formula (the one
    YOLOv11 keeps) computed in float64, on a map whose mean is ``shift``:
    output, gradients of input, scale and bias within 1e-5 of their scale
    (float32 rounding; measured 8e-8 at 0, 1e-6 at 30), and the running statistics moved
    by flax's rule (0.97, the biased variance) within 1e-5 of theirs. At
    shift 0 the float32 flax formula agrees as closely; at 30 its
    ``mean(x^2) - mean(x)^2`` cancels (3.4e-4 measured), the fused
    Welford pass does not."""
    torch.manual_seed(0)
    x = torch.randn(4, 16, 6, 5) * torch.linspace(0.5, 2.0, 16)[:, None,
                                                                 None]
    x, g = x + shift, torch.randn_like(x)
    want = _batchnorm_run(x.double(), g.double(), fused=False)
    got = _batchnorm_run(x, g, fused=True)
    err = max(_of_scale(a, b.float()) for a, b in zip(got[:4], want[:4]))
    bounded(record_property, "fused BatchNorm, of scale", err, "<=", 1e-5)
    stats = max(_of_scale(a, b.float()) for a, b in zip(got[4:], want[4:]))
    bounded(record_property, "running statistics, of scale", stats, "<=",
            1e-5)
    var = x.double().var((0, 2, 3), unbiased=False)
    assert torch.allclose(want[5], 0.97 + 0.03 * var, rtol=1e-12)
    if shift == 0.0:
        flax = _batchnorm_run(x, g, fused=False)
        assert max(_of_scale(a, b) for a, b in zip(got, flax)) <= 1e-5


def test_only_yolo12_fuses_its_batchnorms():
    """YOLO12 trains every BatchNorm fused; YOLOv11 keeps flax's formula,
    bit for bit with eitx's network."""
    from eitx_torch.models.yolo.model import YoloV11, yolov11_spec

    with torch.device("meta"):
        nets = YoloV12(yolov12_spec("n", nc=4)), YoloV11(yolov11_spec("n"))
    for net, fused in zip(nets, (True, False)):
        bns = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
        assert bns and all(m.fused is fused for m in bns)


# -- the l scale ---------------------------------------------------------
def test_l_spec_is_the_published_scale():
    """Layers 6 and 8 at l: hidden width 256 (c2 / 2), 8 ABlocks of 8
    heads of 32 each, MLP 307 (int(256 * 1.2)), areas 4 and 1, a layer
    scale gamma starting at 0.01; the neck's A2C2f have no attention and
    no gamma; C3k2 takes C3k blocks."""
    spec = yolov12_spec("l", nc=4)
    assert (spec.c3k, spec.residual, spec.mlp_ratio) == (True, True, 1.2)
    with torch.device("meta"):
        net = YoloV12(spec)
    for layer, area in ((6, 4), (8, 1)):
        m = net.model[layer]
        assert isinstance(m, A2C2f) and m.cv1.conv.out_channels == 256
        blocks = [b for b in m.modules() if isinstance(b, ABlock)]
        assert len(blocks) == 8
        for b in blocks:
            assert (b.attn.num_heads, b.attn.head_dim, b.attn.area) == (
                8, 32, area)
            assert b.mlp[0].conv.out_channels == 307
    for layer in (11, 14, 17):
        assert net.model[layer].gamma is None and not any(
            isinstance(b, AAttn) for b in net.model[layer].modules())
    state = torch_init_state(net, seed=0)
    for layer in (6, 8):
        g = state[f"model.{layer}.gamma"]
        assert g.shape == (512,) and bool((g == 0.01).all())
    assert "model.6.m.0.0.attn.qkv.conv.weight" in state


@pytest.mark.parametrize("variant,count", [("n", 2_572_320),
                                           ("l", 25_971_536)])
def test_parameter_counts_at_nc80_detect(variant, count):
    """Regression guard of the equations (nc 80, detect, no DFL weights).
    The yaml's own comments, recalled, give n 2,553,904 and l 26,506,496:
    n's gap is a 5x5 position perceiver against the paper's 7x7."""
    with torch.device("meta"):
        net = YoloV12(yolov12_spec(variant, nc=80, segment=False))
    assert sum(p.numel() for p in net.parameters()) == count


def test_initial_state_is_the_seeds_alone():
    """The same seed gives the same bits, another seed others, and torch's
    global random state is left alone."""
    spec = yolov12_spec("n", nc=4)
    before = torch.random.get_rng_state()
    a, b = (yolo12_init_model(spec, 5).state_dict() for _ in range(2))
    c = yolo12_init_model(spec, 6).state_dict()
    assert torch.equal(torch.random.get_rng_state(), before)
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "model.6.m.0.0.attn.qkv.conv.weight"
    assert not torch.equal(a[w], c[w])
    fan_in = a[w][0].numel()
    assert abs(float(a[w].std()) * fan_in ** 0.5 - 1.0) < 0.1


# -- spans, checkpoints, the script --------------------------------------
def _profiled_step(arch: str, variant: str = "n"):
    tr = Trainer(TrainConfig(arch=arch, variant=variant, **STEP_CFG),
                 device="cpu")
    timing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.train_step(synthetic_ct_batch(2, IMG, 4, seed=1))
    spans, counters = timing.recorded()
    timing.clear()
    names = collections.Counter(e.name for e in prof.events()
                                if e.name.startswith("eitx.train."))
    return spans, counters, names


def test_attention_spans_and_scores_are_recorded():
    """Under a profiler a YOLO12 step records ``eitx.train.a2c2f`` once
    for each attention A2C2f (layers 6 and 8) and ``eitx.train.area_attn``
    once an AAttn (2 stages x 2 ABlocks x 2 layers at n), inside the
    forward; the counter adds B a h (N / a)^2 a call."""
    spans, counters, names = _profiled_step("yolo12")
    assert names["eitx.train.a2c2f"] == spans["eitx.train.a2c2f"][
        "calls"] == 2
    assert names["eitx.train.area_attn"] == spans["eitx.train.area_attn"][
        "calls"] == 8
    # n: P4 4x4 in 4 stripes of 4 tokens, 2 heads; P5 2x2 whole, 4 heads
    b = 2
    want = 4 * b * 4 * 2 * 4 ** 2 + 4 * b * 1 * 4 * 4 ** 2
    assert counters == {"eitx.train.attn_scores": want}
    assert spans["eitx.train.forward"]["calls"] == 1


def test_a_yolo11_step_records_no_attention_span():
    spans, counters, names = _profiled_step("yolo11")
    assert "eitx.train.forward" in spans
    assert not any("a2c2f" in n or "area_attn" in n for n in spans)
    assert counters == {} and "eitx.train.area_attn" not in names


def test_checkpoint_round_trip_continues_the_run(tmp_path):
    """A YOLO12 ``.train`` file (the layer scale as flax's ``gamma`` leaf)
    loads into a trainer of another seed equal on every tensor, and the
    next step of both is equal."""
    cfg = TrainConfig(arch="yolo12", variant="l", **STEP_CFG)
    tr = Trainer(cfg, device="cpu")
    tr.train_step(synthetic_ct_batch(2, IMG, 4, seed=1))
    path = str(tmp_path / "y12.train")
    save_checkpoint(path, tr.state)
    fresh = Trainer(cfg, seed=3, device="cpu")
    fresh.state = load_checkpoint(path, fresh.state)
    for n, p in tr.state.params.items():
        assert torch.equal(fresh.state.params[n], p.detach()), n
        assert torch.equal(fresh.opt_state.mu[n], tr.opt_state.mu[n])
    assert fresh.state.step == 1
    batch = synthetic_ct_batch(2, IMG, 4, seed=2)
    assert fresh.train_step(batch) == tr.train_step(batch)
    for n, p in tr.state.params.items():
        assert torch.equal(fresh.state.params[n], p.detach()), n


def test_trainer_refuses_an_unknown_arch():
    with pytest.raises(ValueError, match="arch"):
        Trainer(TrainConfig(arch="yolo13", **STEP_CFG), device="cpu")


def test_train_tissue_trains_yolo12(tmp_path):
    """``train_tissue --arch yolo12`` at imgsz 64, 2 steps on the CPU:
    the .train file, the deployment file with ``arch`` in its meta, and a
    report that says it was not evaluated (no serving runner builds the
    network)."""
    from eitx_torch.models.yolo import convert
    from eitx_torch.scripts.train_tissue import main
    from eitx_torch.train.checkpoint import peek_step

    out = str(tmp_path / "y12.msgpack")
    report = main(["--steps", "2", "--batch", "2", "--imgsz", str(IMG),
                   "--variant", "n", "--n-train", "4", "--arch", "yolo12",
                   "--out", out, "--device", "cpu"])
    assert peek_step(out + ".train") == 2
    meta = convert.peek_checkpoint_meta(out)
    assert meta["arch"] == "yolo12" and meta["steps"] == 2
    assert "macro_iou" not in report and "final_train_metrics" in report


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys\n"
            "import benchmark.reference.yolo12.trainer\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'eitx', 'eitx_torch'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
