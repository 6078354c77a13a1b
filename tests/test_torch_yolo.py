"""YOLOv11 segmenter: checkpoint reading, raw heads, post-processing and
labels of the port against eitx, in float32 on the CPU."""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from eitx.core.config import ModelConfig
from eitx.models.yolo import post as eitx_post
from eitx.models.yolo.infer import TissueSegmenter as EitxSegmenter
from eitx.models.yolo.model import YoloV11 as EitxYolo
from eitx.models.yolo.model import yolov11_spec as eitx_spec
from eitx.train.phantoms import phantom_batch
from eitx_torch.models.yolo import post
from eitx_torch.models.yolo.checkpoint import (
    flax_to_torch_state,
    load_state,
    read_msgpack_checkpoint,
    unpackb,
)
from eitx_torch.models.yolo.infer import TissueSegmenter
from eitx_torch.models.yolo.model import YoloV11, yolov11_spec
from torch_bounds import bounded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_256 = os.path.join(ROOT, "weights", "tissue_n_256.msgpack")


def _msgpack_ext(code, data):
    assert code == 1
    shape, dtype, raw = msgpack.unpackb(data, raw=True)
    return np.frombuffer(raw, dtype=np.dtype(dtype.decode())).reshape(shape)


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        return sum(_assert_same_tree(a[k], b[k], f"{path}/{k}") for k in a)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
        return 1
    assert a == b, path
    return 0


def test_decoder_equals_msgpack_on_every_array():
    with open(CKPT_256, "rb") as fh:
        data = fh.read()
    ref = msgpack.unpackb(data, ext_hook=_msgpack_ext, raw=False,
                          strict_map_key=False)
    n = _assert_same_tree(ref, unpackb(data))
    assert n == 477
    meta, params, stats = read_msgpack_checkpoint(CKPT_256)
    assert meta["variant"] == "n" and meta["proto_stride"] == 2
    assert meta["nc"] == 4 and meta["imgsz"] == 256


def _dev_over_scale(got_nchw, ref_nhwc):
    """Max deviation over the output's scale: the bound of
    tests/test_torch_parity.py:336-340 is 2e-5 of it."""
    ref = np.asarray(ref_nhwc)
    got = got_nchw.detach().numpy().transpose(0, 2, 3, 1)
    d = np.abs(got - ref).max()
    return d / max(1.0, np.abs(ref).max())


def _compare_heads(record_property, fnet, variables, tnet, x):
    out_r = fnet.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out_p = tnet(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    devs = {}
    for i, ((bf, cf), (bp, cp)) in enumerate(
            zip(out_r["levels"], out_p["levels"])):
        devs[f"box level {i}"] = _dev_over_scale(bp, bf)
        devs[f"cls level {i}"] = _dev_over_scale(cp, cf)
    for i, (mf, mp) in enumerate(
            zip(out_r["mask_coefs"], out_p["mask_coefs"])):
        devs[f"coef level {i}"] = _dev_over_scale(mp, mf)
    devs["proto"] = _dev_over_scale(out_p["proto"], out_r["proto"])
    worst = max(devs, key=devs.get)
    record_property("worst head", worst)
    bounded(record_property, "max_dev_over_scale", devs[worst], "<=", 2e-5)


def test_raw_heads_match_eitx_under_trained_checkpoint(record_property):
    ref = EitxSegmenter(256, weights=CKPT_256)
    got = TissueSegmenter(256, weights=CKPT_256, device="cpu")
    x = np.random.default_rng(0).normal(0, 1, (1, 256, 256, 3)).astype(
        np.float32)
    _compare_heads(record_property, ref.model, ref.variables, got.model, x)


def test_raw_heads_match_eitx_random_stride4_weights(record_property):
    """The flax -> torch mapping on a randomly initialized stride-4
    network (the plain ultralytics Proto)."""
    spec = eitx_spec("n", nc=4, segment=True, proto_stride=4)
    fnet = EitxYolo(spec)
    x = np.random.default_rng(1).normal(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, fnet.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    tnet = YoloV11(yolov11_spec("n", nc=4, segment=True, proto_stride=4))
    load_state(tnet, flax_to_torch_state(
        variables["params"], variables["batch_stats"]))
    _compare_heads(record_property, fnet, variables, tnet.eval(), x)


def test_weightless_segmenter_is_eitx_network(record_property):
    """``TissueSegmenter(weights=None, seed)`` (YOLOv11-s) is eitx's
    untrained network of that seed: every parameter equal on every bit,
    and the raw heads at 64^2 within the float32 bound (2e-5 of scale)."""
    ref = EitxSegmenter(64, seed=4)
    got = TissueSegmenter(64, seed=4, device="cpu")
    assert got.spec.depth == ref.spec.depth and got.spec.width == ref.spec.width
    want = flax_to_torch_state(
        jax.device_get(ref.variables["params"]),
        jax.device_get(ref.variables["batch_stats"]))
    state = got.model.state_dict()
    for n, t in want.items():
        np.testing.assert_array_equal(state[n].numpy().view(np.uint32),
                                      t.numpy().view(np.uint32), err_msg=n)
    x = np.random.default_rng(2).normal(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    _compare_heads(record_property, ref.model, ref.variables, got.model, x)


def _phantom_256():
    b = phantom_batch(1, 256, 12, np.random.default_rng(42))
    return (b["images"][0, ..., 0] * 255).astype(np.uint8)


@pytest.mark.parametrize("tta,hw", [(4, (256, 256)), (4, (300, 220)),
                                    (1, (256, 256))])
def test_predict_labels_agree_with_eitx_f32(tta, hw, record_property):
    """(300, 220) exercises the letterbox: an antialiased shrink, the
    grey canvas and the un-letterbox upsample."""
    m = ModelConfig()
    kw = dict(conf=m.axial_conf_per_class, max_det=m.max_detections,
              tta_fill=tta, dtype="float32")
    img = _phantom_256()
    if hw != img.shape:
        rows = np.linspace(0, 255, hw[0]).round().astype(int)
        cols = np.linspace(0, 255, hw[1]).round().astype(int)
        img = np.ascontiguousarray(img[rows][:, cols])
    ref, _ = EitxSegmenter(256, weights=CKPT_256, **kw).predict_labels(img)
    got, _ = TissueSegmenter(256, weights=CKPT_256, device="cpu",
                             **kw).predict_labels(img)
    assert got.shape == ref.shape == hw and got.dtype == np.int32
    bounded(record_property, "agreement", (got == ref).mean(), ">=", 0.999)
    assert set(np.unique(ref)) == set(np.unique(got))


@pytest.mark.parametrize("out_hw", [(32, 40), (33, 41), (10, 13), (7, 9)])
def test_bilinear_resize_matches_jax_image_resize(out_hw, record_property):
    """jax.image.resize(..., "bilinear") against F.interpolate with
    half-pixel centres (align_corners=False), antialiased when shrinking:
    the border clamps the same way in both."""
    import torch.nn.functional as F

    x = np.random.default_rng(0).random((3, 16, 20)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (3, *out_hw),
                                      "bilinear"))
    got = F.interpolate(torch.from_numpy(x)[None], size=out_hw,
                        mode="bilinear", align_corners=False,
                        antialias=out_hw[0] < 16).numpy()[0]
    bounded(record_property, "max_abs", np.abs(got - ref).max(), "<", 2e-6)


def _tied_candidates():
    """12 candidates, scores tied in pairs, overlapping boxes of two
    classes; two candidates under the threshold."""
    boxes = np.array([
        [10, 10, 50, 50], [12, 12, 52, 52], [10, 10, 50, 50],
        [100, 100, 140, 140], [101, 101, 141, 141], [60, 60, 90, 90],
        [61, 61, 91, 91], [10, 10, 50, 50], [200, 10, 240, 50],
        [200, 10, 240, 50], [5, 5, 20, 20], [150, 150, 170, 170],
    ], np.float32)
    scores = np.array([0.9, 0.9, 0.8, 0.8, 0.8, 0.7, 0.7, 0.9, 0.6, 0.6,
                       0.01, 0.02], np.float32)
    classes = np.array([0, 0, 1, 2, 2, 1, 1, 1, 3, 3, 0, 2], np.int32)
    coefs = np.random.default_rng(5).normal(0, 1, (12, 4)).astype(np.float32)
    return boxes, scores, classes, coefs


@pytest.mark.parametrize("conf", [0.3, (0.5, 0.3, 0.75, 0.5)])
def test_nms_with_tied_scores_matches_eitx(conf):
    boxes, scores, classes, coefs = _tied_candidates()
    ref = eitx_post.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores),
                              jnp.asarray(classes), jnp.asarray(coefs),
                              conf, 0.45, 4)
    got = post.nms_batched(
        *(torch.from_numpy(a)[None] for a in (boxes, scores, classes, coefs)),
        conf, 0.45, 4)
    for name in post.Detections._fields:
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name)[0].numpy()
        assert np.array_equal(g, r), (name, g, r)


@pytest.mark.parametrize("out_hw", [(16, 16), (64, 64), (8, 8)])
def test_composition_with_tied_scores_matches_eitx(out_hw, record_property):
    """Painting order: lowest score first, and among equal scores the
    later slot wins (stable argsort). (8, 8) shrinks the 16x16 proto,
    which jax.image.resize antialiases."""
    rng = np.random.default_rng(9)
    k, nm, hp = 6, 4, 16
    proto = rng.normal(0, 1, (hp, hp, nm)).astype(np.float32)
    boxes = np.array([[0, 0, 48, 48], [8, 8, 64, 64], [0, 16, 64, 40],
                      [20, 0, 40, 64], [0, 0, 64, 64], [0, 0, 0, 0]],
                     np.float32)
    scores = np.array([0.5, 0.5, 0.7, 0.7, 0.3, 0.0], np.float32)
    classes = np.array([0, 1, 2, 3, 1, -1], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 0], bool)
    coefs = np.abs(rng.normal(0, 1, (k, nm))).astype(np.float32)
    coefs[:, 0] += 2.0
    proto[..., 0] = np.abs(proto[..., 0])
    det_r = eitx_post.Detections(*(jnp.asarray(a) for a in
                                   (boxes, scores, classes, coefs, valid)))
    ref = np.asarray(eitx_post.compose_label_image(
        jnp.asarray(proto), det_r, (64, 64), out_hw))
    det_p = post.Detections(*(torch.from_numpy(a) for a in
                              (boxes, scores, classes, coefs, valid)))
    got = post.compose_label_image(
        torch.from_numpy(proto.transpose(2, 0, 1).copy()), det_p, (64, 64),
        out_hw).numpy()
    assert len(np.unique(ref)) >= 4
    if out_hw == (hp, hp):
        assert np.array_equal(got, ref)
    else:  # bilinear upsample: rounding may move a pixel on the 0.5 line
        bounded(record_property, "agreement", (got == ref).mean(), ">=", 0.999)
