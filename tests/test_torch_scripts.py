"""The port's scripts (eitx_torch/scripts) against eitx's, on the CPU.

Mirrors tests/test_scripts.py and tests/test_ood_fixture.py: the same
inputs through both packages; files byte-equal where eitx writes text or
PNG, label images at test_torch_yolo.py's float32 agreement bound (0.999
of pixels), and the OOD fixture's ratchets held by the port's own scores.
The training scripts' counterparts are tests/test_torch_train_ckpt.py's.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

from eitx.image import window_normalize as jax_window_normalize
from eitx.io.dicom import write_dicom
from eitx.scripts import build_datasets as jax_build
from eitx.scripts import devtools as jax_devtools
from eitx.scripts import eval_ood_fixture as jax_ood
from eitx.scripts import gen_materials as jax_gen_materials
from eitx.scripts import gen_vent as jax_gen_vent
from eitx.scripts import harvest_trials as jax_harvest
from eitx.scripts import pseudo_label as jax_pseudo
from eitx_torch.core.config import ModelConfig
from eitx_torch.core.weights import find_checkpoint
from eitx_torch.models.yolo.infer import TissueSegmenter
from eitx_torch.scripts import build_datasets, devtools, eval_conf_sweep
from eitx_torch.scripts import eval_ood_fixture as ood
from eitx_torch.scripts import gen_materials, gen_vent, harvest_trials
from eitx_torch.scripts import profile_seg, profile_setup
from eitx_torch.scripts import pseudo_label
from torch_bounds import bounded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DATA = os.path.join(ROOT, "eitx_torch", "data")
CKPT_256 = find_checkpoint("tissue", 256)
CKPT_512 = find_checkpoint("tissue", 512)
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The networks' CPU calls on one thread (the test workers share the
    cores)."""
    # never set back above 1: a batched float32 linalg.solve (oneMKL)
    # later in the same worker can then hang
    torch.set_num_threads(1)


def _phantom_hu(h=128, w=128):
    """tests/test_scripts.py's phantom: body, fat ring, one lung, bone."""
    yy, xx = np.mgrid[0:h, 0:w]
    hu = np.full((h, w), -1000.0)
    body = ((xx - 64) / 50.0) ** 2 + ((yy - 64) / 40.0) ** 2 < 1
    hu[body] = 25.0
    fat = ((xx - 64) / 48.0) ** 2 + ((yy - 64) / 38.0) ** 2 >= 0.82
    hu[body & fat] = -80.0
    lung = ((xx - 45) / 14.0) ** 2 + ((yy - 60) / 18.0) ** 2 < 1
    hu[lung] = -700.0
    bone = ((xx - 64) / 6.0) ** 2 + ((yy - 85) / 5.0) ** 2 < 1
    hu[bone] = 300.0
    return hu, (body * 255).astype(np.uint8)


def _tree(path):
    """{relative path: bytes} of every file under ``path``."""
    out = {}
    for d, _, files in os.walk(path):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = fh.read()
    return out


def _series_zip(path, hu, n):
    px = (hu + 1024).astype(np.int16)
    with zipfile.ZipFile(path, "w") as zf:
        for i in range(n):
            zf.writestr(f"{i}.dcm", write_dicom(px, "1.2.3", i + 1,
                                                rescale_intercept=-1024))
    return str(path)


# --- pseudo-labels (the dataset builders' labeller) -------------------------

def test_pseudo_label_lines_and_stack_match_eitx():
    """The phantom's labels, a stack of two and the YOLO lines are eitx's."""
    hu, mask = _phantom_hu()
    lab = pseudo_label.pseudo_label_slice(hu, mask, device=CPU)
    np.testing.assert_array_equal(lab, jax_pseudo.pseudo_label_slice(hu,
                                                                      mask))
    stack = pseudo_label.pseudo_label_stack(np.stack([hu, hu]),
                                            np.stack([mask, mask]),
                                            device=CPU)
    assert np.array_equal(stack[0], lab) and np.array_equal(stack[1], lab)
    assert pseudo_label.labels_to_yolo_lines(lab) \
        == jax_pseudo.labels_to_yolo_lines(np.asarray(lab))
    assert lab[60, 45] == 2 and lab[85, 64] == 0 and lab[5, 5] == -1


# --- build_datasets ---------------------------------------------------------

def test_build_axial_dataset_matches_eitx(tmp_path):
    """Two DICOM slices of the phantom: the PNG images and the label files
    byte-equal to eitx's."""
    hu, _ = _phantom_hu(128, 128)
    zp = _series_zip(tmp_path / "subj.zip", hu, 2)
    assert build_datasets.build_axial_dataset([zp], str(tmp_path / "port"),
                                              device=CPU) == 2
    assert jax_build.build_axial_dataset([zp], str(tmp_path / "eitx")) == 2
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "eitx")
    assert got == want and len(got) == 4
    assert any(len(v) > 0 for k, v in got.items() if k.startswith("labels"))


def test_build_frontal_dataset_matches_eitx(tmp_path):
    """One frontal image per column of a 64-wide volume, byte-equal."""
    hu, _ = _phantom_hu(64, 64)
    zp = _series_zip(tmp_path / "subj.zip", hu, 4)
    assert build_datasets.build_frontal_dataset([zp], str(tmp_path / "port"),
                                                device=CPU) == 64
    jax_build.build_frontal_dataset([zp], str(tmp_path / "eitx"))
    got = _tree(tmp_path / "port")
    assert got == _tree(tmp_path / "eitx") and len(got) == 64


def test_build_nii_dataset_matches_eitx(tmp_path):
    """Every second slice of a NIfTI volume: images, labels and the
    spacing file byte-equal."""
    from eitx.io.nifti import write_nifti

    hu, _ = _phantom_hu(96, 96)
    vol = np.stack([hu.astype(np.int16)] * 4, axis=-1)
    p = tmp_path / "scan.nii.gz"
    p.write_bytes(write_nifti(vol, pixdim=(1, 0.7, 0.7, 1)))
    assert build_datasets.build_nii_dataset(
        [str(p)], str(tmp_path / "port"), stride=2, device=CPU) == 2
    jax_build.build_nii_dataset([str(p)], str(tmp_path / "eitx"), stride=2)
    got = _tree(tmp_path / "port")
    assert got == _tree(tmp_path / "eitx") and len(got) == 5
    assert abs(float(got["scan_spacing.txt"].split()[0]) - 0.7) < 1e-5


def _phantom_png(path, size=128):
    from eitx_torch.io import to_png_bytes
    from eitx_torch.train.phantoms import phantom_batch

    b = phantom_batch(1, size, 12, np.random.default_rng(42), device=CPU)
    img = (b["images"][0, ..., 0] * 255).astype(np.uint8)
    path.write_bytes(to_png_bytes(img))
    return img


def test_auto_label_images_matches_eitx(tmp_path, record_property):
    """autolabel with the trained 256 checkpoint on a 256 phantom: the
    label file is the port's labels' YOLO lines, and those labels agree
    with eitx's."""
    from eitx.models.yolo.infer import TissueSegmenter as EitxSegmenter

    img = _phantom_png(tmp_path / "a.png", 256)
    assert build_datasets.auto_label_images(
        [str(tmp_path / "a.png")], str(tmp_path / "lab"), CKPT_256,
        imgsz=256, device=CPU) == 1
    got, _ = TissueSegmenter(256, weights=CKPT_256, device=CPU
                             ).predict_labels(img)
    assert (tmp_path / "lab" / "a.txt").read_text() == "\n".join(
        pseudo_label.labels_to_yolo_lines(got))
    want, _ = EitxSegmenter(256, weights=CKPT_256).predict_labels(img)
    bounded(record_property, "agreement", (got == want).mean(), ">=", 0.999)
    assert len(np.unique(got)) >= 3


def test_auto_label_ribs_writes_the_detector_boxes(tmp_path):
    """riblabel on a frontal rib phantom: one line a valid box, in YOLO
    detection form, equal to the boxes the detector returns (the detector
    itself is held to eitx's in tests/test_torch_ribs.py)."""
    from eitx_torch.io import to_png_bytes
    from eitx_torch.models.yolo.infer import RibsDetector
    from torch_series_phantom import frontal_rib_phantom

    weights = os.path.join(ROOT, "weights", "ribs_n_640.msgpack")
    img, _ = frontal_rib_phantom(np.random.default_rng(2024), 640)
    (tmp_path / "f.png").write_bytes(to_png_bytes(img))
    build_datasets.auto_label_ribs([str(tmp_path / "f.png")],
                                   str(tmp_path / "lab"), weights,
                                   device=CPU)
    det = RibsDetector(weights=weights, conf=0.5, device=CPU).predict(img)
    lines = (tmp_path / "lab" / "f.txt").read_text().splitlines()
    assert len(lines) == int(det.valid.sum()) > 0
    x1, y1, x2, y2 = det.boxes[det.valid][0]
    assert lines[0] == (f"0 {(x1 + x2) / 2 / 640:.6f} {(y1 + y2) / 2 / 640:.6f}"
                        f" {(x2 - x1) / 640:.6f} {(y2 - y1) / 640:.6f}")


# --- devtools ---------------------------------------------------------------

def test_devtools_split_and_polyline_match_eitx(tmp_path):
    src = tmp_path / "src"
    (src / "images").mkdir(parents=True)
    (src / "labels").mkdir()
    for i in range(10):
        (src / "images" / f"s{i}.png").write_bytes(b"x")
        if i % 2 == 0:  # half the images are negatives
            (src / "labels" / f"s{i}.txt").write_text("0 0.5 0.5 0.1 0.1")
    assert devtools.split_yolo_dataset(str(src), str(tmp_path / "a"),
                                       0.7) == (7, 3)
    jax_devtools.split_yolo_dataset(str(src), str(tmp_path / "b"), 0.7)
    assert _tree(tmp_path / "a") == _tree(tmp_path / "b")
    coords = [10, 10, 50, 10, 50, 40, 12, 33]
    for close in (False, True):
        np.testing.assert_array_equal(
            devtools.draw_polyline(coords, (64, 64), close),
            jax_devtools.draw_polyline(coords, (64, 64), close))


def test_devtools_lung_overlay_matches_eitx(tmp_path, record_property):
    """scripts/test_lungmask.py's counterpart at imgsz 64: the overlay's
    pixels agree with eitx's at the label bound."""
    hu, _ = _phantom_hu(96, 96)
    p = tmp_path / "s.dcm"
    p.write_bytes(write_dicom((hu + 1024.0).astype(np.uint16), "1.2.3", 1,
                              rescale_intercept=-1024.0, rescale_slope=1.0))
    got = devtools.lung_overlay(str(p), weights=CKPT_256, imgsz=64,
                                device=CPU)
    want = jax_devtools.lung_overlay(str(p), weights=CKPT_256, imgsz=64)
    assert got.shape == (96, 96, 3) and got.dtype == np.uint8
    bounded(record_property, "pixel agreement",
            (got == want).all(-1).mean(), ">=", 0.999)


# --- numpy-only scripts -----------------------------------------------------

def test_gen_vent_and_gen_materials_bytes(tmp_path):
    """The same bytes as eitx's scripts and as the committed data."""
    p = gen_vent.main(str(tmp_path / "vent.csv"))
    q = jax_gen_vent.main(str(tmp_path / "vent_eitx.csv"))
    with open(p, "rb") as a, open(q, "rb") as b, \
            open(os.path.join(PORT_DATA, "vent.csv"), "rb") as c:
        assert a.read() == b.read() == c.read()
    got = gen_materials.main(str(tmp_path / "port"))
    jax_gen_materials.main(str(tmp_path / "eitx"))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "eitx")
    for path in got:
        with open(path, "rb") as a, open(os.path.join(
                PORT_DATA, os.path.basename(path)), "rb") as b:
            assert a.read() == b.read()


def test_harvest_trials_matches_eitx(tmp_path, monkeypatch):
    """A synthetic source with six test lists (2-5 femm-mapped, 6 with a
    body contour): the port's files equal eitx's, whose header cites its
    fixed source path where the port's cites the file it read."""
    polys = ["3 1 2 3 4 5 6", "2 10 20 30 40 50.5 60", "4 7 8 9 10 11 12",
             "0.0 1.25 2 3 4 5 6"]
    src = tmp_path / "mesh_service_trials.py"
    src.write_text("\n".join(f"test_list{n} = {polys!r}" for n in range(1, 7))
                   + "\n")
    cited, extract = jax_harvest._REF, jax_harvest._extract_lists
    monkeypatch.setattr(jax_harvest, "_extract_lists",
                        lambda: extract(str(src)))
    monkeypatch.setattr(jax_harvest, "_OUT", str(tmp_path / "eitx"))
    jax_harvest.main()
    written = harvest_trials.main(str(src), str(tmp_path / "port"))
    assert len(written) == 5
    want = {k: v.replace(cited.encode(), str(src).encode())
            for k, v in _tree(tmp_path / "eitx").items()}
    assert _tree(tmp_path / "port") == want
    text = (tmp_path / "port" / "trial2.txt").read_text().splitlines()
    assert text[-4:] == ["2 1 2 3 4 5 6", "3 10 20 30 40 50.5 60",
                         "4 7 8 9 10 11 12", "0 1.25 2 3 4 5 6"]


# --- eval_ood_fixture -------------------------------------------------------

def test_fixture_rendering_and_transforms_equal_eitx():
    """The rendering (crisp, partial volume, posed, geometry 6) and the
    pose draws are eitx's arrays; the pseudo-labels of the render too."""
    for k in range(3):
        assert ood.fixture_transform(k)["angle"] == \
            jax_ood.fixture_transform(k)["angle"]
    for kw in (dict(), dict(pv_sigma=1.5), dict(transform=ood.fixture_transform(2)),
               dict(geometry=6)):
        hu, body = ood.render_fixture_hu(128, seed=5, **kw)
        want_hu, want_body = jax_ood.render_fixture_hu(128, seed=5, **kw)
        np.testing.assert_array_equal(hu, want_hu)
        np.testing.assert_array_equal(body, want_body)
    hu, body = ood.render_fixture_hu(128, seed=5)
    np.testing.assert_array_equal(
        pseudo_label.pseudo_label_slice(hu, body, hu_scale=1.1, device=CPU),
        jax_pseudo.pseudo_label_slice(hu, body, hu_scale=1.1))


def test_fixture_transform_renders_in_frame():
    """test_ood_fixture.py's pose check on the port: the body stays inside
    the frame and keeps all four tissue classes."""
    for k in range(4):
        hu, body = ood.render_fixture_hu(128, seed=5,
                                         transform=ood.fixture_transform(k))
        b = body > 0
        assert b.mean() > 0.15
        assert not (b[0].any() or b[-1].any() or b[:, 0].any()
                    or b[:, -1].any())
        gt = pseudo_label.pseudo_label_slice(hu, body, device=CPU)
        assert set(np.unique(gt[gt >= 0]).tolist()) == {0, 1, 2, 3}


def test_pseudo_labeler_hu_scale_and_rendering_stats():
    """test_ood_fixture.py's labeller probe and rendering statistics on
    the port: scale 1.0 is the standing labeller, +-10 % moves only
    boundary pixels; the body fills 60-75 % of the frame, lungs > 20 %."""
    hu, body = ood.render_fixture_hu(128, seed=5)
    base = pseudo_label.pseudo_label_slice(hu, body, device=CPU)
    assert np.array_equal(base, pseudo_label.pseudo_label_slice(
        hu, body, hu_scale=1.0, device=CPU))
    for s in (0.9, 1.1):
        pert = pseudo_label.pseudo_label_slice(hu, body, hu_scale=s,
                                               device=CPU)
        assert 0.9 < float((pert == base).mean()) < 1.0
    hu, body = ood.render_fixture_hu(256, seed=5)
    gt = pseudo_label.pseudo_label_slice(hu, body, device=CPU)
    assert 0.6 < float((gt >= 0).mean()) < 0.75
    assert (gt == 2).mean() > 0.2


def test_evaluate_ood_labels_agree_with_eitx(record_property):
    """evaluate_ood's pieces at the 256 slot, seed 5: the serving frame's
    image and ground truth equal to eitx's; the quality-path labels of the
    two segmenters at the label bound; the port's score is its labels'."""
    from eitx.models.yolo.infer import TissueSegmenter as EitxSegmenter
    from eitx_torch.eval.metrics import evaluate_dataset
    from eitx_torch.image import window_normalize

    hu, body = ood.render_fixture_hu(256, seed=5)
    img = window_normalize(hu, 40.0, 400.0, device=CPU).numpy()
    np.testing.assert_array_equal(
        img, np.asarray(jax_window_normalize(hu, 40.0, 400.0)))
    seg = TissueSegmenter(256, weights=CKPT_256, variant="n", max_det=64,
                          device=CPU)
    got = seg.segment_labels(img[None], chunk=1, compose_full=True)[0]
    want = EitxSegmenter(256, weights=CKPT_256, variant="n", max_det=64
                         ).segment_labels(img[None], chunk=1,
                                          compose_full=True)[0]
    bounded(record_property, "agreement", (got == want).mean(), ">=", 0.999)
    res = ood.evaluate_ood(256, seed=5, seg=seg)
    gt = pseudo_label.pseudo_label_slice(hu, body, device=CPU)[::-1, ::-1]
    counts = evaluate_dataset([(gt + 1, got + 1)], n_classes=4)
    assert res["macro_iou"] == round(float(np.mean(
        [counts[c]["iou"] for c in range(4)])), 4)


@pytest.mark.parametrize("given", [dict(conf=0.2), dict(tta_fill=True),
                                   dict(variant="s"),
                                   dict(weights="tissue_n_256.msgpack")])
def test_evaluate_ood_refuses_flags_beside_seg(given):
    """eitx drops conf / tta_fill / variant / weights when a prebuilt
    segmenter is passed; the port raises."""
    seg = TissueSegmenter(64, variant="n", max_det=8, device=CPU)
    with pytest.raises(ValueError, match="seg decides"):
        ood.evaluate_ood(64, seg=seg, **given)


def test_labeler_perturb_scores_the_flagged_segmenter(monkeypatch, capsys):
    """--labeler-perturb passes --conf-per-class and the TTA flags into
    the probe: every probe call scores a segmenter with that conf and two
    views (eitx's probe scored conf 0.3, one view)."""
    seen = []

    def fake(size, seed=5, hu_scale=1.0, gt_perturb=None, seg=None, **kw):
        seen.append((seg.conf, seg.tta_views, kw))
        return {"macro_iou": 0.5, "per_class_iou": {}}

    monkeypatch.setattr(ood, "evaluate_ood", fake)
    out = ood.main(["--labeler-perturb", "--sizes", "256", "--seeds", "1",
                    "--conf-per-class", "0.15,0.05,0.1,0.15", "--tta-fill",
                    "--device", CPU])
    assert len(seen) == 6
    assert all(s == ((0.15, 0.05, 0.1, 0.15), 2, {}) for s in seen)
    assert set(out["256"]["macro_iou_by_gt_perturb"]) == {"psf", "dilate",
                                                          "erode"}
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out


RATCHETS = [  # tests/test_ood_fixture.py's, at measured - 0.07
    (256, {}, None, 0.73, {"muscles": 0.64, "lung": 0.87}),
    (512, {}, None, 0.76, {"muscles": 0.75, "fat": 0.83}),
    (256, {"serving": True}, None, 0.79, {"muscles": 0.73, "lung": 0.87}),
    (512, {"serving": True}, None, 0.83, {"muscles": 0.77, "lung": 0.87}),
    (256, {}, 5, None, {"lung": 0.78}),
    (512, {}, 4, None, {"lung": 0.83}),
]


@pytest.mark.parametrize("size,kw,pose,macro,per", RATCHETS)
def test_serving_checkpoints_on_patient_fixture(size, kw, pose, macro, per):
    """test_ood_fixture.py's ratchets held by the port's scores: the raw
    checkpoints, the promoted serving configuration (per-class conf, 4
    TTA views) and the worst single-pass pose of each slot."""
    m = ModelConfig()
    conf, tta = ((m.axial_conf_per_class, m.axial_tta_fill)
                 if kw.get("serving") else (0.3, False))
    seg = TissueSegmenter(size, weights=CKPT_256 if size == 256 else CKPT_512,
                          variant="n", max_det=m.max_detections, conf=conf,
                          tta_fill=tta, device=CPU)
    res = ood.evaluate_ood(size, seed=5, seg=seg,
                           transform=None if pose is None
                           else ood.fixture_transform(pose))
    if macro is not None:
        assert res["macro_iou"] >= macro, res
    for name, floor in per.items():
        assert res["per_class_iou"][name] >= floor, res


def test_eval_conf_sweep_one_setting():
    """sweep_one at 64 with one seed and one pose: every score in [0, 1],
    the setting echoed back."""
    res = eval_conf_sweep.sweep_one(64, CKPT_256, (0.3, 0.2, 0.2, 0.3),
                                    seeds=1, transforms=1, device=CPU)
    assert res["conf"] == [0.3, 0.2, 0.2, 0.3]
    for k in ("crisp_macro_iou", "posed_macro_mean", "pv15_macro_iou",
              "phantom_clean_macro_iou", "phantom_anatomy_macro_iou"):
        assert 0.0 <= res[k] <= 1.0, (k, res)


# --- profilers --------------------------------------------------------------

def test_profile_seg_on_cpu(capsys):
    """The five stages, the fused program and the C=4 probe at 64^2,
    batch 2; the network's FLOPs counted (not a device rate: the CPU's
    host clock)."""
    res = profile_seg.main(["--imgsz", "64", "--batch", "2", "--repeats",
                            "1", "--device", CPU])
    for k in ("preproc", "network", "decode", "nms", "compose"):
        assert res[k]["ms"] > 0 and res[k]["share_of_fused"] > 0
    assert res["network"]["gflops"] > 0.1
    assert res["timer"] == "host clock" and res["device"] == "cpu"
    assert res["network_c4_slice_ms"] > 0 and res["slices_per_sec_fused"] > 0
    assert json.loads(capsys.readouterr().out) == res


def test_profile_setup_on_cpu(capsys, monkeypatch):
    """Every stage of the low-rank setup, one subject and a stack of 2,
    and the whole build (on lc-14 thoraxes: the stages, not their times,
    are under test here)."""
    mesh = profile_setup.thorax_mesh
    monkeypatch.setattr(profile_setup, "thorax_mesh",
                        lambda lc, **kw: mesh(lc=14.0, **kw))
    res = profile_setup.main(["--batch", "2", "--repeats", "1", "--device",
                              CPU])
    stages = [k for k in res if k.startswith("s") and k[1].isdigit()]
    assert len(stages) == 10
    for k in stages + ["build"]:
        assert res[k]["single_ms"] > 0 and res[k]["batch_ms"] > 0
    assert res["batch"] == 2 and res["rank"] % 256 == 0
    out = capsys.readouterr().out
    assert '"s7_eigh_r"' in out and '"build"' in out
