"""The pipeline of the port against eitx: mask cleanup, contours, the
whole run_jpg_png request and the four modes that ingest a container
(DICOM series, DICOM frame, NIfTI, zipped image)."""

import inspect
import io
import os
import zipfile

import numpy as np
import pytest
import torch

from eitx.core.config import ModelConfig as EitxModelConfig
from eitx.core.config import PipelineConfig as EitxPipelineConfig
from eitx.core.config import SimulationConfig as EitxSimulationConfig
from eitx.masks import cleanup_labels as eitx_cleanup
from eitx.pipeline import Pipeline as EitxPipeline
from eitx.pipeline.modes import labels_to_polygons as eitx_labels_to_polygons
from eitx.train.phantoms import phantom_batch
from eitx_torch.core.config import ModelConfig, PipelineConfig, SimulationConfig
from eitx_torch.core.timing import Timer
from eitx_torch.image import body_mask_from_hu, window_normalize
from eitx_torch.io import to_png_bytes, write_dicom, write_nifti
from eitx_torch.masks import cleanup_labels
from eitx_torch.pipeline import Pipeline, labels_to_polygons
from test_pipeline import synth_labels
from torch_bounds import bounded
from torch_series_phantom import series_volume, series_zip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_256 = os.path.join(ROOT, "weights", "tissue_n_256.msgpack")
RIBS = os.path.join(ROOT, "weights", "ribs_n_640.msgpack")


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


def _record(monkeypatch, owner, name, calls):
    """Append every result of ``owner.<name>`` to ``calls``."""
    inner = getattr(owner, name)

    def recorded(*args, **kwargs):
        out = inner(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(owner, name, recorded)


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    """One run_jpg_png request of each package at the serving
    ModelConfig (bfloat16, per-class conf, 4 flip views) on the 256
    phantom, with the labels and the mesh of each; then eitx's request
    again with the port's labels in place of its own."""
    import eitx.pipeline.modes as eitx_modes
    import eitx_torch.pipeline.modes as port_modes

    b = phantom_batch(1, 256, 12, np.random.default_rng(42))
    img = (b["images"][0, ..., 0] * 255).astype(np.uint8)
    ref_pipe = EitxPipeline(EitxPipelineConfig(
        model=EitxModelConfig(axial_weights_256=CKPT_256),
        sim=EitxSimulationConfig(n_points=3),
        results_dir=str(tmp_path_factory.mktemp("eitx")),
    ))
    got_pipe = Pipeline(PipelineConfig(
        model=ModelConfig(axial_weights_256=CKPT_256),
        sim=SimulationConfig(n_points=3),
        results_dir=str(tmp_path_factory.mktemp("port")),
    ), device="cpu")
    seen = {k: [] for k in ("ref_labels", "got_labels", "ref_mesh",
                            "got_mesh")}
    timer = Timer()
    with pytest.MonkeyPatch.context() as mp:
        _record(mp, eitx_modes, "create_mesh", seen["ref_mesh"])
        _record(mp, port_modes, "create_mesh", seen["got_mesh"])
        ref_seg, got_seg = (p._segmenter_for(img) for p in (ref_pipe,
                                                            got_pipe))
        _record(mp, ref_seg, "predict_labels", seen["ref_labels"])
        _record(mp, got_seg, "predict_labels", seen["got_labels"])
        ref = ref_pipe.run_jpg_png(img)
        got = got_pipe.run_jpg_png(img, timer=timer)
        port_labels = seen["got_labels"][0]
        mp.setattr(ref_seg, "predict_labels", lambda image: port_labels)
        ref_on_port_labels = ref_pipe.run_jpg_png(img)
    seen["ref_on_port_labels"] = ref_on_port_labels
    return ref, got, timer, seen


def test_run_jpg_png_answer_matches_eitx(answers):
    ref, got, _, _ = answers
    assert got["status"] == "success"
    assert sorted(got) == sorted(ref)
    classes = lambda ans: {ln.split()[0] for ln in ans["text_data"][2:]}  # noqa: E731
    assert classes(got) == classes(ref)
    assert len(classes(got)) >= 2


def test_run_jpg_png_at_the_serving_dtype_matches_eitx(answers,
                                                       record_property):
    """At the serving dtype the port's labels differ from eitx's on a few
    pixels: a convolution sums in another order and rounds to the other
    bfloat16 (tests/test_torch_yolo_bf16.py), and the difference travels
    to the labels. Everything after the labels is held to eitx: eitx's
    own request, given the port's labels, writes the port's polygons,
    mesh and answer image, and its .dat at the bound of the float32 modes
    below (the two packages' float32 Cholesky factors of one mesh
    differ, tests/test_torch_fem.py; rtol 2e-4 does not hold there in
    float32 either: max_rel 7.5e-4 in the zip mode, 7.7e-3 here).
    Against eitx's own labels the polygons, the mesh and so the .dat
    move with those pixels (a contour vertex by a few pixels, a few
    elements change class, the electrodes sit on another boundary), so
    that comparison is recorded, not bounded."""
    ref, got, _, seen = answers
    (ref_labels, _), (got_labels, _) = (seen["ref_labels"][0],
                                        seen["got_labels"][0])
    bounded(record_property, "label agreement", (got_labels ==
                                                 ref_labels).mean(), ">=",
            0.9995)  # tests/test_torch_yolo_bf16.py: LABEL_AGREEMENT
    tail = seen["ref_on_port_labels"]
    assert got["text_data"] == tail["text_data"]
    # create_mesh returns (image, mesh); eitx's second call is the tail's
    ref_mesh, got_mesh = seen["ref_mesh"][1][1], seen["got_mesh"][0][1]
    for key in ("NODES", "TRIANGLES", "CLASS"):
        assert np.array_equal(np.asarray(got_mesh[key]),
                              np.asarray(ref_mesh[key])), key
    assert got["image"] == tail["image"]  # the stage grid, as PNG
    v_tail = np.loadtxt(tail["saved_file_name"])
    v = np.loadtxt(got["saved_file_name"])
    rel = np.abs(v - v_tail) / (np.abs(v_tail) + 1e-9)
    bounded(record_property, "max_rel", rel.max(), "<", 2e-2)
    bounded(record_property, "mean_rel", rel.mean(), "<", 2e-3)
    v_ref = np.loadtxt(ref["saved_file_name"])
    record_property("polygons equal eitx's own",
                    got["text_data"] == ref["text_data"])
    record_property(".dat max difference over eitx's own scale",
                    float(np.abs(v - v_ref).max() / np.abs(v_ref).max()))


def test_run_jpg_png_writes_the_dataset(answers):
    _, got, timer, _ = answers
    rows = open(got["saved_file_name"]).read().strip().split("\n")
    assert len(rows) == 3 * 12  # n_points * n_spir
    assert all(len(r.split()) == 208 for r in rows)
    assert np.isfinite(np.loadtxt(got["saved_file_name"])).all()
    assert set(timer.as_dict()) == {
        "segmentation", "cleanup", "contours", "mesh", "simulation", "answer"}


# --------------------------------------------------------------------------
# The modes that ingest a container: DICOM series (auto / custom), DICOM
# frame, NIfTI, zipped image. Both pipelines run in float32 with the
# trained rib detector and the 256 tissue checkpoint, so that labels,
# contours and the answer image can be held to equality; the serving dtype
# of the detector has its own case in tests/test_torch_ribs.py.

SERIES_SEED, SERIES_SLICES, SERIES_SIZE = 1, 160, 256
MODE_SPANS = {"segmentation", "cleanup", "contours", "mesh", "simulation",
              "answer"}


def _spy(pipe, name, seen):
    """Record every call of ``pipe.<name>``: its arguments, in the order
    of the signature, and its result."""
    inner = getattr(pipe, name)
    signature = inspect.signature(inner)

    def outer(*args, **kwargs):
        out = inner(*args, **kwargs)
        bound = signature.bind(*args, **kwargs)
        seen.setdefault(name, []).append((tuple(bound.arguments.values()),
                                          out))
        return out

    setattr(pipe, name, outer)


@pytest.fixture(scope="module")
def mode_runs(tmp_path_factory):
    """Every container mode through both pipelines on the same inputs:
    name -> (eitx answer, port answer, eitx calls, port calls, spans)."""
    vol = series_volume(SERIES_SEED, SERIES_SLICES, SERIES_SIZE)
    nii = np.ascontiguousarray(vol[70:79].transpose(2, 1, 0)) - 1024
    png = to_png_bytes(_axial_256())
    inputs = {
        "run_dicom_sequences_auto": series_zip(vol, write_dicom).getvalue(),
        "run_dicom_sequences_custom": series_zip(
            vol, write_dicom, custom_offset=1).getvalue(),
        "run_dicom_frame": series_zip(vol[100:103], write_dicom).getvalue(),
        "run_nii": _zip_of("scan.nii.gz", write_nifti(
            nii.astype(np.int16), pixdim=(1.0, 0.8, 0.9, 2.0))),
        "run_jpg_png_zip": _zip_of("slice.png", png),
    }
    ref = EitxPipeline(EitxPipelineConfig(
        model=EitxModelConfig(ribs_weights=RIBS, axial_weights_256=CKPT_256,
                              dtype="float32"),
        sim=EitxSimulationConfig(n_points=3),
        results_dir=str(tmp_path_factory.mktemp("eitx_modes")),
    ))
    got = Pipeline(PipelineConfig(
        model=ModelConfig(ribs_weights=RIBS, axial_weights_256=CKPT_256,
                          dtype="float32"),
        sim=SimulationConfig(n_points=3),
        results_dir=str(tmp_path_factory.mktemp("port_modes")),
    ), device="cpu")
    runs = {}
    for mode, data in inputs.items():
        seen_ref, seen_got = {}, {}
        for pipe, seen in ((ref, seen_ref), (got, seen_got)):
            for name in ("_axial_from_dicom_slice", "_run_tail"):
                pipe.__dict__.pop(name, None)
                _spy(pipe, name, seen)
        timer = Timer()
        runs[mode] = (getattr(ref, mode)(io.BytesIO(data)),
                      getattr(got, mode)(io.BytesIO(data), timer=timer),
                      seen_ref, seen_got, timer.as_dict())
    return runs


def _zip_of(name, data):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr(name, data)
    return buf.getvalue()


def _axial_256():
    b = phantom_batch(1, 256, 12, np.random.default_rng(42))
    return (b["images"][0, ..., 0] * 255).astype(np.uint8)


def _assert_same_tail_inputs(seen_ref, seen_got):
    (args_r, _), = seen_ref["_run_tail"]
    (args_g, _), = seen_got["_run_tail"]
    body_r, mask_r, spacing_r, ribs_r, _ = args_r
    body_g, mask_g, spacing_g, ribs_g, _ = args_g
    assert body_g.dtype == np.uint8 and body_g.shape == (256, 256)
    assert np.array_equal(body_g, np.asarray(body_r))
    if mask_r is None:
        assert mask_g is None
    else:
        assert mask_g.dtype == np.uint8
        assert np.array_equal(mask_g, np.asarray(mask_r)) and mask_g.any()
    assert [float(v) for v in spacing_g] == [float(v) for v in spacing_r]
    if ribs_r is None:
        assert ribs_g is None
    else:  # annotate_ribs on the path: the drawn frontal view, pixel-equal
        assert np.array_equal(ribs_g, ribs_r)


@pytest.mark.parametrize("mode,spans", [
    ("run_dicom_sequences_auto", {"ingest", "frontal", "ribs", "preprocess"}),
    ("run_dicom_sequences_custom", {"ingest", "frontal", "ribs",
                                    "preprocess"}),
    ("run_dicom_frame", {"ingest", "preprocess"}),
    ("run_nii", {"ingest", "preprocess"}),
    ("run_jpg_png_zip", {"ingest"}),
])
def test_container_mode_matches_eitx(mode_runs, mode, spans, record_property):
    ref, got, seen_ref, seen_got, timed = mode_runs[mode]
    assert got["status"] == "success"
    assert sorted(got) == sorted(ref)
    _assert_same_tail_inputs(seen_ref, seen_got)
    assert got["text_data"] == ref["text_data"]
    assert len({ln.split()[0] for ln in got["text_data"][2:]}) >= 2
    assert got["image"] == ref["image"]  # the stage grid, as PNG
    v_ref = np.loadtxt(ref["saved_file_name"])
    v = np.loadtxt(got["saved_file_name"])
    assert v.shape == v_ref.shape == (3 * 12, 208)
    assert np.isfinite(v).all()
    # the oracle bound that tests/test_torch_fem.py states for two float32
    # solves of one thorax mesh
    rel = np.abs(v - v_ref) / np.abs(v_ref)
    bounded(record_property, "max_rel", rel.max(), "<", 2e-2)
    bounded(record_property, "mean_rel", rel.mean(), "<", 2e-3)
    assert set(timed) == MODE_SPANS | spans


def _picked(seen):
    (args, _), = seen["_axial_from_dicom_slice"]
    return args[0].instance_number


def test_series_modes_pick_the_slice_eitx_picks(mode_runs):
    _, _, seen_ref, seen_got, _ = mode_runs["run_dicom_sequences_auto"]
    auto = _picked(seen_got)
    assert auto == _picked(seen_ref)
    assert 1 < auto < SERIES_SLICES  # not a clamped pick
    _, _, seen_ref, seen_got, _ = mode_runs["run_dicom_sequences_custom"]
    assert _picked(seen_got) == _picked(seen_ref) == auto + 1  # offset 1


def test_frame_mode_takes_the_last_slice_read(mode_runs):
    _, _, seen_ref, seen_got, _ = mode_runs["run_dicom_frame"]
    assert _picked(seen_got) == _picked(seen_ref) == 3


def test_body_mask_is_built_on_the_flipped_image(mode_runs):
    """The DICOM quirk: mask of the flipud'd HU image over the slice
    rotated by 180 degrees; the NIfTI path builds its mask unflipped."""
    _, _, _, seen_got, _ = mode_runs["run_dicom_frame"]
    (args, (body, mask, _)), = seen_got["_axial_from_dicom_slice"]
    ds = args[0]
    hu = ds.pixel_array.astype(np.float32) * ds.rescale_slope \
        + ds.rescale_intercept
    assert np.array_equal(
        mask, body_mask_from_hu(hu[::-1], device="cpu").numpy())
    norm = window_normalize(hu, device="cpu").numpy()
    assert np.array_equal(body, norm * (mask > 0))
    assert not np.array_equal(mask, mask[::-1])  # the flip is visible


def test_ribs_slot_is_built_eagerly_and_can_be_replaced(tmp_path):
    """``ribs_weights`` None: the detector is built at once, with random
    weights from the seed, under the attribute ``ribs``. A detector that
    finds fewer than seven right-side ribs makes the series modes raise,
    as in eitx."""
    from eitx_torch.core.errors import SliceSelectionError
    from eitx_torch.models.yolo.post import Detections

    cfg = PipelineConfig(
        model=ModelConfig(axial_weights_256=CKPT_256, variant="n"),
        sim=SimulationConfig(n_points=3), results_dir=str(tmp_path))
    pipe, again = Pipeline(cfg, device="cpu"), Pipeline(cfg, device="cpu")
    assert pipe.ribs.spec.nc == 1 and pipe.ribs.imgsz == 640
    assert pipe.ribs.max_det == cfg.model.max_detections
    for a, b in zip(pipe.ribs.model.parameters(),
                    again.ribs.model.parameters()):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)

    class SixRibs:
        def predict(self, front):
            assert front.dtype == np.uint8 and front.shape == (24, 256)
            boxes = np.array([[150.0, 3.0 * i, 200.0, 3.0 * i + 2]
                              for i in range(6)])
            return Detections(boxes, np.ones(6), np.zeros(6, np.int32),
                              np.zeros((6, 1)), np.ones(6, bool))

    pipe.ribs = SixRibs()
    vol = series_volume(SERIES_SEED, 24, SERIES_SIZE)
    with pytest.raises(SliceSelectionError, match="got 6"):
        pipe.run_dicom_sequences_auto(series_zip(vol, write_dicom))


def test_every_mode_defaults_to_the_card():
    assert inspect.signature(Pipeline).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Pipeline(PipelineConfig())
    for mode in ("run_jpg_png", "run_jpg_png_zip", "run_dicom_frame",
                 "run_nii", "run_dicom_sequences_auto",
                 "run_dicom_sequences_custom"):
        assert "timer" in inspect.signature(getattr(Pipeline, mode)).parameters
