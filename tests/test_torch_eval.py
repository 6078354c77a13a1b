"""The port's eval harness and jax-free leaves against eitx's: pixel
metrics on seeded masks, the harness with one stub segmenter, the TOML
config and the file logger."""

import dataclasses
import logging

import numpy as np
import pytest

import eitx.eval as eitx_eval
import eitx_torch.eval as port_eval
from eitx.contours.formats import to_yolo_label
from eitx.core.log import setup_logging as eitx_setup_logging
from eitx.core.toml_config import load_pipeline_config as eitx_load_config
from eitx.eval.harness import PixelLevelEvaluator as EitxEvaluator
from eitx.eval.metrics import mean_mask_iou as eitx_mean_iou
from eitx_torch.core.log import setup_logging
from eitx_torch.core.toml_config import load_pipeline_config
from eitx_torch.eval import PixelLevelEvaluator
from eitx_torch.eval.metrics import mean_mask_iou
from eitx_torch.io import to_png_bytes


def _seeded_masks(seed, n=4, shape=(48, 40)):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 5, (n, shape[0] // 4, shape[1] // 4))
    gt = np.kron(blocks, np.ones((1, 4, 4), np.int64)).astype(np.uint8)
    noise = rng.random(gt.shape) < 0.15
    pred = np.where(noise, rng.integers(0, 5, gt.shape), gt).astype(np.uint8)
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_eitx(seed):
    gt, pred = _seeded_masks(seed)
    pairs = list(zip(gt, pred))
    assert (port_eval.confusion_counts(gt[0], pred[0])
            == eitx_eval.confusion_counts(gt[0], pred[0]))
    for counts in port_eval.confusion_counts(gt, pred).values():
        assert port_eval.pixel_metrics(counts) == eitx_eval.pixel_metrics(
            counts)
    got = port_eval.evaluate_dataset(pairs)
    assert got == eitx_eval.evaluate_dataset(pairs)
    assert mean_mask_iou(gt, pred) == eitx_mean_iou(gt, pred)
    assert port_eval.print_results(got) == eitx_eval.print_results(got)


def test_yolo_label_masks_equal_eitx(tmp_path):
    rng = np.random.default_rng(3)
    lines = []
    for cid in range(4):
        c = rng.uniform(0.3, 0.7, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
        pts = c + rng.uniform(0.05, 0.25, (9, 1)) * np.stack(
            [np.cos(ang), np.sin(ang)], 1)
        lines.append(f"{cid} " + " ".join(f"{v:.5f}" for v in pts.ravel()))
    lines.append("2 0.1 0.1 0.2")  # too short: skipped by both
    path = tmp_path / "a.txt"
    path.write_text("\n".join(lines) + "\n\n")
    got = port_eval.mask_from_yolo_labels(str(path), 64, 48)
    assert got.shape == (48, 64) and len(np.unique(got)) > 2
    assert np.array_equal(got, eitx_eval.mask_from_yolo_labels(str(path),
                                                               64, 48))
    missing = str(tmp_path / "none.txt")
    assert np.array_equal(port_eval.mask_from_yolo_labels(missing, 8, 6),
                          eitx_eval.mask_from_yolo_labels(missing, 8, 6))


class _StubSegmenter:
    """Labels every image by thresholds of its grey levels: the same
    function for both harnesses; records the batches it was given."""

    def __init__(self):
        self.batches = []

    def segment_labels(self, images):
        self.batches.append(images.shape)
        return np.digitize(images, [40, 100, 160, 220]).astype(np.int32) - 1


def _dataset(tmp_path):
    """Five same-shape images and one of another shape (a ragged last
    chunk at batch 2), with YOLO polygon labels."""
    rng = np.random.default_rng(5)
    img_dir, lab_dir = tmp_path / "images", tmp_path / "labels"
    img_dir.mkdir()
    lab_dir.mkdir()
    for k in range(6):
        h, w = (64, 64) if k < 5 else (48, 80)
        img = np.kron(rng.integers(0, 255, (h // 8, w // 8)),
                      np.ones((8, 8))).astype(np.uint8)
        (img_dir / f"im{k}.png").write_bytes(to_png_bytes(img))
        lines = [to_yolo_label(cid, np.array(
            [[x0, y0], [x0 + 20, y0], [x0 + 20, y0 + 15], [x0, y0 + 15]]),
            (h, w)) for cid, (x0, y0) in enumerate(
                rng.integers(0, min(h, w) - 20, (3, 2)))]
        (lab_dir / f"im{k}.txt").write_text("\n".join(lines))
    return str(img_dir), str(lab_dir)


def test_harness_equals_eitx_with_one_segmenter(tmp_path):
    images, labels = _dataset(tmp_path)
    ref_seg, port_seg = _StubSegmenter(), _StubSegmenter()
    want = EitxEvaluator(segmenter=ref_seg, images_dir=images,
                         labels_dir=labels, batch=2).evaluate()
    got = PixelLevelEvaluator(segmenter=port_seg, images_dir=images,
                              labels_dir=labels, batch=2,
                              device="cpu").evaluate()
    assert got == want
    # whole chunks go through in one call, the ragged one image by image
    assert port_seg.batches == ref_seg.batches == [
        (2, 64, 64), (2, 64, 64), (1, 64, 64), (1, 48, 80)]
    assert PixelLevelEvaluator(segmenter=_StubSegmenter(), images_dir=images,
                               labels_dir=labels).evaluate(limit=3) == \
        EitxEvaluator(segmenter=_StubSegmenter(), images_dir=images,
                      labels_dir=labels).evaluate(limit=3)


def test_harness_builds_the_segmenter_on_the_device():
    ev = PixelLevelEvaluator(img_size=256, device="cpu")
    assert ev.segmenter.imgsz == 256
    assert ev.segmenter.device.type == "cpu"


TOML = """
results_dir = "out"
save_dataset = false
default_pixel_spacing_image = [0.5, 0.6]

[image]
window_level = 50
window_width = 350

[sim]
n_points = 42
solver = "cholesky"
precision = "f64"

[mesh]
lc = 9.5

[model]
axial_conf = 0.25

[classes]
compat_swap_lung_fat = true
"""


def test_toml_config_equals_eitx_field_by_field(tmp_path):
    path = tmp_path / "cfg.toml"
    path.write_text(TOML)
    got = dataclasses.asdict(load_pipeline_config(str(path)))
    want = dataclasses.asdict(eitx_load_config(str(path)))
    assert got == want
    assert got["sim"]["n_points"] == 42 and got["mesh"]["lc"] == 9.5
    assert got["default_pixel_spacing_image"] == (0.5, 0.6)


@pytest.mark.parametrize("text", ["[sim]\nbogus_key = 1\n", "bogus = 2\n"])
def test_toml_config_rejects_what_eitx_rejects(tmp_path, text):
    path = tmp_path / "bad.toml"
    path.write_text(text)
    with pytest.raises(ValueError) as want:
        eitx_load_config(str(path))
    with pytest.raises(ValueError) as got:
        load_pipeline_config(str(path))
    assert str(got.value) == str(want.value)


def test_logging_to_a_file(tmp_path):
    log = setup_logging(log_dir=str(tmp_path / "port"))
    try:
        assert log.name == "eitx_torch"
        logging.getLogger("eitx_torch.serve").info("hello from the port")
        for h in log.handlers:
            h.flush()
        text = (tmp_path / "port" / "eitx.log").read_text()
        assert "hello from the port" in text and "eitx_torch.serve" in text
        # the same format as eitx's logger
        ref = eitx_setup_logging(log_dir=str(tmp_path / "eitx"))
        assert [h.formatter._fmt for h in log.handlers] == [
            h.formatter._fmt for h in ref.handlers]
    finally:
        for name in ("eitx_torch", "eitx"):
            for h in logging.getLogger(name).handlers:
                h.close()
            logging.getLogger(name).handlers.clear()
