"""The rib detector of the port against eitx on the CPU: weights carried
across, raw detect heads, the letterbox, post-processing with tied scores,
the trained checkpoint on frontal phantoms (float32 and the serving
dtype), instance masks, slice selection and the rib annotation."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eitx.core.config import ModelConfig
from eitx.core.errors import SliceSelectionError as RefSliceSelectionError
from eitx.models.yolo import post as eitx_post
from eitx.models.yolo.infer import RibsDetector as EitxRibs
from eitx.models.yolo.infer import TissueSegmenter as EitxSegmenter
from eitx.models.yolo.infer import _prep_batch as eitx_prep_batch
from eitx.models.yolo.model import YoloV11 as EitxYolo
from eitx.models.yolo.model import yolov11_spec as eitx_spec
from eitx.pipeline.viz import annotate_ribs as eitx_annotate_ribs
from eitx.select import select_axial_slice_number as eitx_select
from eitx.train.phantoms import phantom_batch
from eitx_torch.core.errors import SliceSelectionError
from eitx_torch.models.yolo import post
from eitx_torch.models.yolo.checkpoint import (
    flax_to_torch_state,
    load_state,
    read_msgpack_checkpoint,
)
from eitx_torch.models.yolo.infer import (
    RibsDetector,
    TissueSegmenter,
    _prep_batch,
)
from eitx_torch.models.yolo.model import YoloV11, yolov11_spec
from eitx_torch.pipeline.viz import annotate_ribs
from eitx_torch.select import select_axial_slice_number
from torch_bounds import bounded
from torch_series_phantom import frontal_rib_phantom, series_volume

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RIBS = os.path.join(ROOT, "weights", "ribs_n_640.msgpack")
CKPT_256 = os.path.join(ROOT, "weights", "tissue_n_256.msgpack")
SERVING = ModelConfig()


# ------------------------------------------------------------- weights, heads
def _state_keys(model):
    return {k for k in model.state_dict()
            if not k.endswith("num_batches_tracked")}


def test_ribs_checkpoint_fits_the_detect_only_network():
    meta, params, stats = read_msgpack_checkpoint(RIBS)
    assert meta["variant"] == "n" and int(meta["nc"]) == 1
    state = flax_to_torch_state(params, stats)
    model = YoloV11(yolov11_spec("n", nc=1, segment=False))
    assert set(state) == _state_keys(model)  # none left over, none missing
    assert not any("cv4" in k or "proto" in k for k in state)
    load_state(model, state)
    for k, v in model.state_dict().items():
        if k in state:
            assert torch.equal(v, state[k]), k


def _max_dev_over_scale(out_ref, out_port):
    devs = []
    for (bf, cf), (bp, cp) in zip(out_ref["levels"], out_port["levels"]):
        for r, p in ((bf, bp), (cf, cp)):
            r = np.asarray(r)
            assert r.dtype == np.float32 and p.dtype == torch.float32
            d = np.abs(p.numpy().transpose(0, 2, 3, 1) - r).max()
            devs.append(d / max(1.0, np.abs(r).max()))
    return max(devs)


def test_random_detect_weights_carry_across(record_property):
    """A randomly initialized detect-only network of eitx (variant n,
    imgsz 128): same keys, raw heads within 2e-5 of their scale."""
    fnet = EitxYolo(eitx_spec("n", nc=1, segment=False))
    x = np.random.default_rng(1).normal(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, fnet.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    state = flax_to_torch_state(variables["params"],
                                variables["batch_stats"])
    tnet = YoloV11(yolov11_spec("n", nc=1, segment=False))
    assert set(state) == _state_keys(tnet)
    load_state(tnet, state)
    out_r = fnet.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out_p = tnet.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert "proto" not in out_p and "mask_coefs" not in out_p
    bounded(record_property, "max_dev_over_scale",
            _max_dev_over_scale(out_r, out_p), "<=", 2e-5)


@pytest.fixture(scope="module")
def detectors():
    """eitx's and the port's detector with the trained checkpoint at the
    serving settings, per dtype."""
    kw = dict(weights=RIBS, conf=SERVING.ribs_conf,
              max_det=SERVING.max_detections)
    return {dt: (EitxRibs(dtype=dt, **kw),
                 RibsDetector(dtype=dt, device="cpu", **kw))
            for dt in ("float32", SERVING.dtype)}


def test_serving_dtype_detect_path_is_float32_on_rounded_weights(
        detectors, record_property):
    """``ModelConfig.dtype`` is bfloat16, yet eitx's detect path computes
    in float32: bfloat16 variables meet the float32 canvas and flax
    promotes. The port's float32 copy of the rounded network gives the
    same raw heads."""
    assert SERVING.dtype == "bfloat16"
    ref, got = detectors["bfloat16"]
    assert jax.tree_util.tree_leaves(ref.variables)[0].dtype == jnp.bfloat16
    assert next(got.model.parameters()).dtype == torch.bfloat16
    img = np.random.default_rng(0).integers(0, 255, (1, 300, 512)).astype(
        np.uint8)
    x_r = eitx_prep_batch(img, 640)[0]
    assert x_r.dtype == jnp.float32
    out_r = ref.model.apply(ref.variables, x_r, train=False)
    with torch.no_grad():
        out_p = got._float32_network()(_prep_batch(img, 640, "cpu")[0])
    bounded(record_property, "max_dev_over_scale",
            _max_dev_over_scale(out_r, out_p), "<=", 2e-5)


# ------------------------------------------------------------------ letterbox
@pytest.mark.parametrize("shape", [
    (300, 512),       # a short series: scaled up, pad_y 132
    (303, 512),       # up, odd remainder: 640 - 379 rows
    (800, 512),       # a long series: scaled down by 0.8
    (700, 401),       # down by 0.914, odd remainder: 640 - 367 columns
    (640, 333),       # no resize, odd remainder
    (640, 640),       # nothing to do
    (97, 512, 3),     # colour input, up
    (901, 333, 3),    # colour input, down
], ids=str)
def test_prep_batch_matches_eitx(shape, record_property):
    img = np.random.default_rng(sum(shape)).integers(
        0, 255, (2, *shape)).astype(np.uint8)
    x_r, scale_r, px_r, py_r = eitx_prep_batch(img, 640)
    x_p, scale_p, px_p, py_p = _prep_batch(img, 640, "cpu")
    assert (scale_p, px_p, py_p) == (scale_r, px_r, py_r)
    assert x_p.dtype == torch.float32 and x_p.shape == (2, 3, 640, 640)
    bounded(record_property, "max_abs",
            np.abs(x_p.numpy().transpose(0, 2, 3, 1) - np.asarray(x_r)).max(),
            "<", 2e-6)


# ------------------------------------------------------------ post-processing
def _raw_outputs(nc, segment, seed=0, s=64):
    """Seeded raw head maps (NHWC) at strides 8/16/32 of an s x s input.
    Class logits take few distinct values, so scores tie in droves."""
    rng = np.random.default_rng(seed)
    out = {"levels": [], "strides": (8, 16, 32)}
    coefs = []
    for stride in out["strides"]:
        g = s // stride
        box = rng.normal(0, 2.0, (2, g, g, 64)).astype(np.float32)
        cls = rng.choice([-3.0, -0.5, 0.5, 1.5, 1.5, 2.5],
                         (2, g, g, nc)).astype(np.float32)
        out["levels"].append((box, cls))
        coefs.append(rng.normal(0, 1, (2, g, g, 8)).astype(np.float32))
    if segment:
        out["mask_coefs"] = coefs
        out["proto"] = rng.normal(0, 1, (2, s // 4, s // 4, 8)).astype(
            np.float32)
    return out


def _to_jax(out):
    res = dict(out, levels=[(jnp.asarray(b), jnp.asarray(c))
                            for b, c in out["levels"]])
    if "proto" in out:
        res["mask_coefs"] = [jnp.asarray(m) for m in out["mask_coefs"]]
        res["proto"] = jnp.asarray(out["proto"])
    return res


def _to_torch(out):
    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    res = dict(out, levels=[(nchw(b), nchw(c)) for b, c in out["levels"]])
    if "proto" in out:
        res["mask_coefs"] = [nchw(m) for m in out["mask_coefs"]]
        res["proto"] = nchw(out["proto"])
    return res


def _assert_same_detections(ref, got, record_property, box_tol=1e-4,
                            score_tol=1e-6):
    assert np.array_equal(np.asarray(got.valid), np.asarray(ref.valid))
    assert np.asarray(ref.valid).any()
    assert np.array_equal(np.asarray(got.classes), np.asarray(ref.classes))
    bounded(record_property, "max_box_px",
            np.abs(np.asarray(got.boxes) - np.asarray(ref.boxes)).max(),
            "<=", box_tol)
    bounded(record_property, "max_score",
            np.abs(np.asarray(got.scores) - np.asarray(ref.scores)).max(),
            "<=", score_tol)


@pytest.mark.parametrize("nc,conf", [(1, 0.3), (4, 0.3),
                                     (4, (0.7, 0.3, 0.9, 0.5))])
def test_postprocess_detect_with_tied_scores(nc, conf, record_property):
    out = _raw_outputs(nc, segment=False, seed=nc)
    ref = eitx_post.postprocess_detect(_to_jax(out), conf, 0.45, 16)
    got = post.postprocess_detect(_to_torch(out), conf, 0.45, 16)
    assert got.boxes.shape == (2, 16, 4) and got.coefs.shape == (2, 16, 1)
    _assert_same_detections(ref, got, record_property)


def test_process_masks_and_postprocess_segment(record_property):
    out = _raw_outputs(4, segment=True, seed=7)
    det_r, masks_r = eitx_post.postprocess_segment(
        _to_jax(out), (64, 64), 0.3, 0.45, 16)
    det_p, masks_p = post.postprocess_segment(
        _to_torch(out), (64, 64), 0.3, 0.45, 16)
    _assert_same_detections(det_r, det_p, record_property)
    assert np.allclose(det_p.coefs.numpy(), np.asarray(det_r.coefs),
                       atol=1e-6)
    masks_r = np.asarray(masks_r)
    assert masks_p.shape == masks_r.shape == (2, 16, 64, 64)
    assert masks_p.dtype == torch.bool and masks_r.any()
    bounded(record_property, "mask agreement",
            (masks_p.numpy() == masks_r).mean(), ">=", 0.999)
    one = post.process_masks(
        _to_torch(out)["proto"][1], post.Detections(*(t[1] for t in det_p)),
        (64, 64))
    assert torch.equal(one, masks_p[1])


# ------------------------------------------------------- the trained detector
def _fronts():
    """Frontal views: the detector's own size, a short series scaled up
    (160 slices of 256 columns) and a long one scaled down (800 rows)."""
    square, _ = frontal_rib_phantom(np.random.default_rng(2024), 640)
    vol = series_volume(1, 160, 256)
    up = eitx_minmax(vol[:, 128, :])
    tall, _ = frontal_rib_phantom(np.random.default_rng(5), 800)
    return {"square": square, "up": up, "down": tall[:, 80:720]}


def eitx_minmax(x):
    from eitx.image import minmax_normalize_u8

    return np.array(minmax_normalize_u8(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("front", ["square", "up", "down"])
def test_trained_detector_matches_eitx(detectors, front, dtype,
                                       record_property):
    img = _fronts()[front]
    ref_det, got_det = detectors[dtype]
    ref = ref_det.predict(img)
    got = got_det.predict(img)
    for name in ("boxes", "scores", "classes", "coefs", "valid"):
        assert isinstance(getattr(got, name), np.ndarray)
        assert getattr(got, name).shape == np.asarray(getattr(ref, name)).shape
    n = int(np.asarray(ref.valid).sum())
    record_property("valid boxes", n)
    assert int(got.valid.sum()) == n and n >= 14
    assert np.array_equal(got.valid, np.asarray(ref.valid))
    bounded(record_property, "max_box_px",
            np.abs(got.boxes - np.asarray(ref.boxes)).max(), "<=", 0.05)
    assert not got.boxes[~got.valid].any()  # invalid slots are zeroed
    width = img.shape[1]
    want_pick = eitx_select(np.asarray(ref.boxes)[np.asarray(ref.valid)], 0,
                            image_width=width)
    pick = select_axial_slice_number(got.boxes[got.valid], 0,
                                     image_width=width)
    assert pick == want_pick
    right = np.sort(got.boxes[got.valid & (got.boxes[:, 0] > width / 2), 1])
    assert right[5] <= pick[-1] <= right[6] + 1


def test_random_detector_is_seeded():
    """Without a checkpoint the detector runs on random weights drawn from
    its seed: the same detections every time, in ``max_det`` slots."""
    img = _fronts()["up"]
    a = RibsDetector(variant="n", imgsz=128, device="cpu").predict(img)
    b = RibsDetector(variant="n", imgsz=128, device="cpu").predict(img)
    assert a.boxes.shape == (64, 4) and a.valid.shape == (64,)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    c = RibsDetector(variant="n", imgsz=128, seed=1, device="cpu")
    assert not np.array_equal(c.predict(img).scores, a.scores)


def test_detector_refuses_a_checkpoint_of_other_classes():
    from eitx_torch.core.errors import ModelError

    with pytest.raises(ModelError, match="nc=4"):
        RibsDetector(weights=CKPT_256, device="cpu")


# -------------------------------------------------------------- instance masks
def test_segment_matches_eitx_on_a_letterboxed_slice(record_property):
    b = phantom_batch(1, 256, 12, np.random.default_rng(42))
    img = (b["images"][0, ..., 0] * 255).astype(np.uint8)
    rows = np.linspace(0, 255, 300).round().astype(int)
    cols = np.linspace(0, 255, 220).round().astype(int)
    img = np.ascontiguousarray(img[rows][:, cols])[None]
    det_r, masks_r = EitxSegmenter(256, weights=CKPT_256).segment(img)
    det_p, masks_p = TissueSegmenter(256, weights=CKPT_256,
                                     device="cpu").segment(img)
    # scores come from the network: the raw heads' 2e-5 bound applies
    _assert_same_detections(det_r, det_p, record_property, box_tol=0.05,
                            score_tol=2e-5)
    assert masks_p.shape == masks_r.shape == (1, 64, 300, 220)
    assert masks_p.dtype == np.bool_ and masks_r.any()
    bounded(record_property, "mask agreement", (masks_p == masks_r).mean(),
            ">=", 0.999)


# ------------------------------------------------------------ slice selection
def _boxes(n_right, n_left=3, seed=0):
    rng = np.random.default_rng(seed)
    ys = rng.permutation(np.arange(20.0, 20.0 + 31.5 * n_right, 31.5))
    right = [[300.0 + rng.uniform(0, 40), y, 420.0, y + 12.0] for y in ys]
    left = [[60.0, 30.0 + 40 * i, 200.0, 45.0 + 40 * i]
            for i in range(n_left)]
    return np.array(right + left, np.float32)


@pytest.mark.parametrize("n_right,offset", [(7, 0), (9, 0), (9, 2), (12, -3)])
def test_select_axial_slice_number_matches_eitx(n_right, offset):
    boxes = _boxes(n_right, seed=n_right)
    got = select_axial_slice_number(boxes, offset, image_width=512)
    assert got == eitx_select(boxes, offset, image_width=512)
    assert all(isinstance(v, int) for v in got)


@pytest.mark.parametrize("boxes", [_boxes(6), np.zeros((0, 4), np.float32)],
                         ids=["six", "none"])
def test_fewer_than_seven_right_side_ribs_raise(boxes):
    with pytest.raises(SliceSelectionError, match="at least 7"):
        select_axial_slice_number(boxes, 0, image_width=512)
    with pytest.raises(RefSliceSelectionError):
        eitx_select(boxes, 0, image_width=512)


# ------------------------------------------------------------------ annotation
@pytest.mark.parametrize("with_valid", [True, False])
def test_annotate_ribs_pixel_equal(with_valid):
    front = np.random.default_rng(3).integers(0, 255, (160, 256)).astype(
        np.uint8)
    boxes = _boxes(9, seed=4) * 0.5
    valid = np.ones(len(boxes), bool)
    valid[[1, 10]] = False
    numbers = select_axial_slice_number(boxes[valid], 0, image_width=256)
    args = (front, boxes, valid if with_valid else None, numbers)
    got = annotate_ribs(*args)
    assert got.shape == (160, 256, 3) and got.dtype == np.uint8
    assert np.array_equal(got, eitx_annotate_ribs(*args))
    assert (got != np.stack([front] * 3, -1)).any()
