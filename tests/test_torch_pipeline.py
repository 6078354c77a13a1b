"""The jpg_png tail of the port against eitx: mask cleanup, contours and
the whole run_jpg_png request."""

import os

import numpy as np
import pytest

from eitx.core.config import ModelConfig as EitxModelConfig
from eitx.core.config import PipelineConfig as EitxPipelineConfig
from eitx.core.config import SimulationConfig as EitxSimulationConfig
from eitx.masks import cleanup_labels as eitx_cleanup
from eitx.pipeline import Pipeline as EitxPipeline
from eitx.pipeline.modes import labels_to_polygons as eitx_labels_to_polygons
from eitx.train.phantoms import phantom_batch
from eitx_torch.core.config import ModelConfig, PipelineConfig, SimulationConfig
from eitx_torch.core.timing import Timer
from eitx_torch.masks import cleanup_labels
from eitx_torch.pipeline import Pipeline, labels_to_polygons
from test_pipeline import synth_labels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_256 = os.path.join(ROOT, "weights", "tissue_n_256.msgpack")


def _mask_case(name):
    """The tests/test_masks.py cleanup cases, plus seeded speckle."""
    if name == "body_fill":
        lab = np.full((20, 20), -1, np.int32)
        lab[5:15, 5:15] = 2
        body = np.zeros((20, 20), np.uint8)
        body[2:18, 2:18] = 255
        return lab, body
    if name == "small_components":
        lab = np.full((30, 30), -1, np.int32)
        lab[5:25, 5:25] = 1
        lab[10:18, 10:18] = 2
        lab[20, 20] = 0
        return lab, np.full((30, 30), 255, np.uint8)
    if name == "no_body":
        lab = np.full((16, 16), -1, np.int32)
        lab[4:12, 4:12] = 3
        return lab, None
    rng = np.random.default_rng(4)
    lab = rng.integers(-1, 4, (32, 32)).astype(np.int32)
    lab = np.repeat(np.repeat(lab, 2, 0), 2, 1)
    body = (rng.random((64, 64)) > 0.3).astype(np.uint8) * 255
    return lab, (body if name == "speckle_body" else None)


@pytest.mark.parametrize("name", ["body_fill", "small_components", "no_body",
                                  "speckle", "speckle_body"])
def test_cleanup_identical_to_eitx(name):
    lab, body = _mask_case(name)
    ref = np.asarray(eitx_cleanup(lab, body))
    got = cleanup_labels(lab, body, device="cpu").numpy()
    assert np.array_equal(got, ref)


def test_labels_to_polygons_identical_to_eitx():
    lab, _ = synth_labels()
    assert labels_to_polygons(lab) == eitx_labels_to_polygons(lab)


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    b = phantom_batch(1, 256, 12, np.random.default_rng(42))
    img = (b["images"][0, ..., 0] * 255).astype(np.uint8)
    ref = EitxPipeline(EitxPipelineConfig(
        model=EitxModelConfig(axial_weights_256=CKPT_256),
        sim=EitxSimulationConfig(n_points=3),
        results_dir=str(tmp_path_factory.mktemp("eitx")),
    )).run_jpg_png(img)
    timer = Timer()
    got = Pipeline(PipelineConfig(
        model=ModelConfig(axial_weights_256=CKPT_256),
        sim=SimulationConfig(n_points=3),
        results_dir=str(tmp_path_factory.mktemp("port")),
    ), device="cpu").run_jpg_png(img, timer=timer)
    return ref, got, timer


def test_run_jpg_png_answer_matches_eitx(answers):
    ref, got, _ = answers
    assert got["status"] == "success"
    assert sorted(got) == sorted(ref)
    classes = lambda ans: {ln.split()[0] for ln in ans["text_data"][2:]}  # noqa: E731
    assert classes(got) == classes(ref)
    assert len(classes(got)) >= 2


def test_run_jpg_png_writes_the_dataset(answers):
    _, got, timer = answers
    rows = open(got["saved_file_name"]).read().strip().split("\n")
    assert len(rows) == 3 * 12  # n_points * n_spir
    assert all(len(r.split()) == 208 for r in rows)
    assert np.isfinite(np.loadtxt(got["saved_file_name"])).all()
    assert set(timer.as_dict()) == {
        "segmentation", "cleanup", "contours", "mesh", "simulation", "answer"}
