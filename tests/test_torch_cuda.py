"""Card-only tests of the port: the CUDA kernel against its plain
version, and the device path against the CPU path.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode); it
carries the ``cuda`` marker and skips without a card. The file imports
neither JAX nor eitx, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import collections
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")

sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the smoke run's edge cases and list check)

EDGE_CASES = {name: (pts, polys)
              for name, pts, polys in chip_smoke.pip_edge_cases()}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _random_polys(rng, c, p):
    centres = rng.uniform(64, 448, (c, 1, 2))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (c, p)), axis=1)
    rad = rng.uniform(10, 120, (c, p))
    return centres + np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)


def _pip_case(case, dev):
    if isinstance(case, str):
        pts, polys = EDGE_CASES[case]
    else:
        q, c, p = case
        rng = np.random.default_rng(q + c + p)
        pts = rng.uniform(0, 512, (q, 2))
        polys = _random_polys(rng, c, p)
    return (torch.as_tensor(pts, dtype=torch.float32, device=dev),
            torch.as_tensor(polys, dtype=torch.float32, device=dev))


PIP_CASES = [(32768, 32, 512), (1000, 3, 700), (5, 1, 4), *EDGE_CASES]


@pytest.mark.parametrize("case", PIP_CASES, ids=str)
def test_pip_kernel_equals_plain_version(dev, case):
    from eitx_torch.mesh import pip

    pts, polys = _pip_case(case, dev)
    before = pip.pip_launches
    got = pip.points_in_polys(pts, polys)
    torch.cuda.synchronize()
    assert pip.pip_launches == before + 1
    assert torch.equal(got, pip.points_in_polys_ref(pts, polys))


@pytest.mark.parametrize("case", PIP_CASES, ids=str)
def test_pip_prologue_equals_live_edges_ref(dev, case):
    from eitx_torch.mesh import pip

    _, polys = _pip_case(case, dev)
    before = pip.live_edges_launches
    records = chip_smoke.check_live_edges(polys)  # raises where they differ
    assert pip.live_edges_launches == before + 1
    assert records == int((torch.roll(polys[:, :, 1], -1, 1)
                           != polys[:, :, 1]).sum())


def test_pip_kernel_takes_only_aligned_contiguous_tensors(dev):
    from eitx_torch.mesh import pip

    pts = torch.zeros((8, 2), device=dev)
    polys = torch.zeros((2, 4, 2), device=dev)
    shifted = torch.zeros(17, device=dev)[1:].view(8, 2)  # 4-byte aligned
    for bad_pts, bad_polys in [(shifted, polys), (pts, polys.transpose(0, 1)),
                               (pts, shifted.view(2, 4, 2))]:
        with pytest.raises(ValueError):
            pip.points_in_polys(bad_pts, bad_polys)


def test_pip_kernel_known_points(dev):
    from eitx_torch.mesh import pip

    got = pip.points_in_polys(
        torch.tensor([[5.0, 5.0], [15.0, 5.0], [-1.0, 3.0], [9.9, 9.9]],
                     device=dev),
        torch.tensor([[[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [0.0, 10.0]]],
                     device=dev),
    )[:, 0]
    assert got.tolist() == [True, False, False, True]


def test_mesh_on_card_equals_goldens(dev):
    from eitx_torch.mesh import create_mesh

    with open(os.path.join(DATA, "real_slice_polygons.txt")) as fh:
        polys = [ln.strip() for ln in fh
                 if ln.strip() and not ln.startswith("#")]
    _, mesh = create_mesh(["1", "1"], polys, 10, 1.3, 1, True,
                          show_meshing_result_method="no", device=dev)
    hist = dict(sorted(collections.Counter(
        np.asarray(mesh["CLASS"]).tolist()).items()))
    assert hist == {0: 243, 1: 563, 2: 1669, 3: 1565, 4: 1}


def test_cleanup_on_card_equals_cpu(dev):
    from eitx_torch.masks import cleanup_labels

    rng = np.random.default_rng(4)
    lab = np.repeat(np.repeat(
        rng.integers(-1, 4, (64, 64)).astype(np.int32), 4, 0), 4, 1)
    body = (rng.random((256, 256)) > 0.2).astype(np.uint8)
    for b in (None, body):
        got = cleanup_labels(lab, b, device=dev).cpu()
        assert torch.equal(got, cleanup_labels(lab, b, device="cpu"))


def _hu_phantom():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_series_phantom import thorax_hu

    rng = np.random.default_rng(11)
    hu = thorax_hu(rng, 512) + rng.normal(0, 12.0, (512, 512)).astype(
        np.float32)
    hu[480:486, 60:450] = 200.0  # CT-table strip
    return hu


@pytest.mark.parametrize("name", [
    "body_mask_from_hu", "body_mask_from_hu_flipud", "window_normalize",
    "window_normalize_int16", "minmax_normalize_u8",
    "minmax_normalize_u8_int16", "hu_transform_uint16", "binary_close",
    "largest_component_ties", "fill_holes"])
def test_image_on_card_equals_cpu(dev, name):
    from eitx_torch import image

    hu = _hu_phantom()
    ties = np.zeros((64, 64), bool)
    ties[4:12, 4:20] = ties[30:46, 40:48] = True  # two components of 128 px
    calls = {
        "body_mask_from_hu": lambda d: image.body_mask_from_hu(hu, device=d),
        "body_mask_from_hu_flipud": lambda d: image.body_mask_from_hu(
            hu, flipud=True, device=d),
        "window_normalize": lambda d: image.window_normalize(hu, device=d),
        # whole-numbered HU: the exact quotient is an integer on every
        # 80th value, where a division through the reciprocal shows
        "window_normalize_int16": lambda d: image.window_normalize(
            np.rint(hu).astype(np.int16), device=d),
        "minmax_normalize_u8": lambda d: image.minmax_normalize_u8(
            hu, device=d),
        "minmax_normalize_u8_int16": lambda d: image.minmax_normalize_u8(
            np.rint(hu).astype(np.int16), device=d),
        "hu_transform_uint16": lambda d: image.hu_transform(
            (hu + 1024).clip(0).astype(np.uint16), 1.0, -1024.0, device=d),
        "binary_close": lambda d: image.binary_close(hu > -500, 5, device=d),
        "largest_component_ties": lambda d: image.largest_component(
            ties, device=d),
        "fill_holes": lambda d: image.fill_holes(
            (hu > -500) & (hu < 1000), device=d),
    }
    on_card = calls[name](dev)
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.cpu(), calls[name]("cpu"))
    if name == "largest_component_ties":
        assert on_card[5, 5] and not on_card[31, 41]  # the least root stays


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rib_detector_on_card_equals_cpu(dev, dtype):
    """The trained detector on the frontal plane of a seeded series: the
    card against the CPU, both in float32 arithmetic with TF32 off."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from eitx_torch.image import minmax_normalize_u8
    from eitx_torch.models.yolo.infer import RibsDetector
    from eitx_torch.select import select_axial_slice_number
    from torch_series_phantom import series_volume

    vol = series_volume(1, 160, 256)
    front = minmax_normalize_u8(vol[:, 128, :], device="cpu").numpy()
    weights = os.path.join(ROOT, "weights", "ribs_n_640.msgpack")
    card = RibsDetector(weights=weights, dtype=dtype, device=dev)
    assert next(card._float32_network().parameters()).is_cuda
    got = card.predict(front)
    want = RibsDetector(weights=weights, dtype=dtype,
                        device="cpu").predict(front)
    assert np.array_equal(got.valid, want.valid) and got.valid.sum() >= 14
    assert np.abs(got.boxes - want.boxes).max() <= 0.05
    pick = select_axial_slice_number(got.boxes[got.valid], 0, image_width=256)
    assert pick == select_axial_slice_number(want.boxes[want.valid], 0,
                                             image_width=256)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_segmenter_on_card_agrees_with_cpu(dev, dtype):
    """The trained 512 segmenter at the serving settings on the smoke
    fixture's slice: the card against the CPU port. cuDNN sums a
    convolution in another order than oneDNN, so a few elements round to
    the neighbouring value and the labels are held to the card's bound
    against eitx (PERF.md section 2: agreement >= 0.99)."""
    from eitx_torch.core.config import ModelConfig
    from eitx_torch.models.yolo.infer import TissueSegmenter

    image = np.load(os.path.join(DATA, "torch_smoke_512.npz"))["image"]
    m = ModelConfig()
    kw = dict(weights=os.path.join(ROOT, "weights", "tissue_n_512.msgpack"),
              conf=m.axial_conf_per_class, max_det=m.max_detections,
              tta_fill=m.axial_tta_fill, dtype=dtype)
    card = TissueSegmenter(512, device=dev, **kw)
    assert next(card.model.parameters()).is_cuda
    got, _ = card.predict_labels(image)
    want, _ = TissueSegmenter(512, device="cpu", **kw).predict_labels(image)
    assert (got == want).mean() >= 0.99
    assert set(np.unique(got)) == set(np.unique(want))


def _disk_subject(nb, rings, seed=0, radius=100.0):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from meshfix import disk_mesh_with_classes

    nodes, tris, cls = disk_mesh_with_classes(nb, rings)
    scale = radius * (1.0 + 0.02 * np.random.default_rng(seed).standard_normal())
    return {"NODES": nodes * scale, "TRIANGLES": tris, "CLASS": cls}


def _rel_to_max(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_factory_on_card_is_batched_and_byte_stable(dev, tmp_path):
    """Three subjects in two node buckets at the serving frame count: every
    subject batched, the same bytes on a second run, each subject within
    the reference's batched-vs-single bound (tests/test_spectral.py:81) of
    its single-subject run on the card and of the CPU's batched run."""
    from eitx_torch.core.config import SimulationConfig
    from eitx_torch.fem import simulate_eit_monitoring
    from eitx_torch.pipeline.batch import generate_batch

    subjects = [("s0", _disk_subject(40, 6, 0)), ("s1", _disk_subject(44, 5, 1)),
                ("s2", _disk_subject(64, 8, 2))]
    cfg = SimulationConfig(pad_nodes_to=256, pad_elems_to=1024)
    runs = [generate_batch(subjects, str(tmp_path / d), cfg, device=dev)
            for d in ("a", "b")]
    generate_batch(subjects, str(tmp_path / "cpu"), cfg, device="cpu")
    for sid, mesh in subjects:
        assert all(r["subjects"][sid]["batched"] for r in runs)
        a, b, c = (tmp_path / d / f"results_{sid}.dat" for d in ("a", "b", "cpu"))
        assert a.read_bytes() == b.read_bytes()
        got = np.loadtxt(a)[:100]
        assert got.shape == (100, 208)
        single, _ = simulate_eit_monitoring(mesh, cfg, device=dev)
        for ref in (single, np.loadtxt(c)[:100]):
            assert np.allclose(got, ref, rtol=2e-4, atol=1e-7)


def _family_bound(solver, electrode_model, precision):
    """Card vs CPU, scale-relative: the bounds of the CPU parity tests
    (tests/test_torch_fem_solvers.py)."""
    if precision == "f64":
        return 1e-4 if solver == "cg" and electrode_model == "point" else 1e-8
    if electrode_model == "cem":
        return 3e-3
    return 5e-3 if solver == "cg" else 2e-4


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("electrode_model", ["point", "cem"])
@pytest.mark.parametrize("solver", ["spectral", "spectral_full", "cholesky",
                                    "cg"])
def test_solver_family_on_card_equals_cpu(dev, solver, electrode_model,
                                          precision):
    from eitx_torch.core.config import SimulationConfig
    from eitx_torch.fem import simulate_eit_monitoring

    cfg = SimulationConfig(n_points=4, solver=solver, z_contact=5e-3,
                           electrode_model=electrode_model,
                           precision=precision)
    # the unit disk of the CPU parity tests: the contact conductance grows
    # with edge length and the tissue stiffness does not, so at a radius of
    # 100 mesh units the float32 CEM of both packages sits 5-8 % of scale
    # from float64
    mesh = _disk_subject(48, 6, radius=1.0)
    got, _ = simulate_eit_monitoring(mesh, cfg, device=dev)
    want, _ = simulate_eit_monitoring(mesh, cfg, device="cpu")
    assert got.shape == (4, 208) and np.isfinite(got).all()
    assert _rel_to_max(got, want) < _family_bound(solver, electrode_model,
                                                   precision)


def test_femm_path_on_card_equals_cpu(dev):
    """Admittance, the frequency sweep and Sheffield monitoring: the card
    against the CPU, within the CPU parity tests' bound (1e-3 of scale)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from eitx_torch.fem import (
        create_protocol,
        forward_solve_admittance,
        place_electrodes_equal_spacing,
        sheffield_monitoring,
        simulate_eit_spectroscopy,
    )
    from meshfix import disk_mesh_with_classes

    nodes, tris, cls = disk_mesh_with_classes(48, 6)
    el = place_electrodes_equal_spacing(nodes, tris, 16, starting_angle=np.pi)
    p = create_protocol(16, 1, 1, "std")
    rng = np.random.default_rng(6)
    sigma = rng.uniform(0.05, 0.5, tris.shape[0])
    eps = rng.uniform(1e3, 3e4, tris.shape[0])
    got, want = (forward_solve_admittance(
        nodes, tris, sigma, eps, 5e4, el, p.ex_mat, p.meas_mat,
        nodes.shape[0], device=d).cpu().numpy() for d in (dev, "cpu"))
    assert _rel_to_max(got, want) < 1e-3
    mesh = {"NODES": nodes * 100.0, "TRIANGLES": tris, "CLASS": cls}
    got, want = (simulate_eit_spectroscopy(mesh, [1e4, 5e4, 2e5, 1e6],
                                           device=d) for d in (dev, "cpu"))
    assert _rel_to_max(got, want) < 1e-3
    th = np.arctan2(nodes[el][:, 1], nodes[el][:, 0])
    tang = np.stack([-np.sin(th), np.cos(th)], 1) * 0.04
    elecs = np.stack([np.stack([nodes[e] - t, nodes[e] + t, nodes[e]])
                      for e, t in zip(el, tang)])
    sig = np.full((8, tris.shape[0]), 0.3)
    sig[:, cls == 2] = np.linspace(0.10, 0.24, 8)[:, None]
    got, want = (sheffield_monitoring(nodes, tris, sig, np.zeros_like(sig),
                                      5e4, elecs, device=d)
                 for d in (dev, "cpu"))
    assert got.shape == (8, 16, 16) and _rel_to_max(got, want) < 1e-3


def _imaging_disk():
    """The classed disk of the CPU inverse tests at 100 mesh units, its
    linearization and a breathing monitoring simulated on the CPU."""
    from eitx_torch.core.config import SimulationConfig
    from eitx_torch.fem import simulate_eit_monitoring
    from eitx_torch.fem.inverse import monitoring_linearization

    mesh = _disk_subject(48, 6, radius=100.0)
    cfg = SimulationConfig(n_points=8, pad_nodes_to=256, pad_elems_to=512)
    v, _ = simulate_eit_monitoring(mesh, cfg, device="cpu")
    return mesh, cfg, v, monitoring_linearization(mesh, cfg=cfg)


def test_jacobian_on_card_float32_vs_float64(dev):
    """The adjoint Jacobian on the card in float32 against float64 on the
    card, and the difference images against the CPU's: float32's own error
    (tests/test_torch_inverse.py's bound, 2e-5 of scale; the images 3e-4)."""
    from eitx_torch.fem import reconstruct_monitoring
    from eitx_torch.fem.inverse import _difference_jacobian

    mesh, cfg, v, (info, sigma_ref, el, proto) = _imaging_disk()
    ds, imager = reconstruct_monitoring(mesh, v, cfg=cfg, device=dev)
    assert imager.jac.device.type == "cuda"
    idx = [torch.as_tensor(np.asarray(a), device=dev)
           for a in (info.element, el, proto.ex_mat, proto.meas_mat)]
    f64 = _difference_jacobian(
        torch.as_tensor(info.node, dtype=torch.float64, device=dev), idx[0],
        torch.as_tensor(sigma_ref, dtype=torch.float64, device=dev),
        *idx[1:], info.node.shape[0]).cpu().numpy()
    assert _rel_to_max(imager.jac.cpu().numpy(), f64) < 2e-5
    want, _ = reconstruct_monitoring(mesh, v, cfg=cfg, device="cpu")
    assert _rel_to_max(ds, want) < 3e-4


def test_greit_mask_on_card_equals_cpu(dev):
    from eitx_torch.fem import greit_monitoring

    mesh, cfg, v, _ = _imaging_disk()
    got, on_card = greit_monitoring(mesh, v, cfg=cfg, device=dev)
    want, on_cpu = greit_monitoring(mesh, v, cfg=cfg, device="cpu")
    assert on_card.R.device.type == "cuda"
    assert np.array_equal(on_card.mask, on_cpu.mask)
    assert _rel_to_max(on_card.R.cpu().numpy(), on_cpu.R.numpy()) < 3e-4
    assert _rel_to_max(got, want) < 3e-4


def test_gauss_newton_loop_never_waits_for_the_card(dev):
    """Six iterations on the card: the loop makes the host wait for the
    device nowhere (torch's sync debug mode; after a first call, which
    sets up the card's solver), and sigma agrees with the CPU's run."""
    from eitx_torch.fem import (
        create_protocol,
        gauss_newton_absolute,
        place_electrodes_equal_spacing,
    )
    import eitx_torch.fem.inverse as inverse
    from eitx_torch.fem.oracle import forward_solve_oracle

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from meshfix import disk_mesh

    nodes, tris = disk_mesh(48, 7)
    el = place_electrodes_equal_spacing(nodes, tris, 16, starting_angle=np.pi)
    p = create_protocol(16, 1, 1, "std")
    cent = nodes[tris].mean(1)
    sigma_true = np.full((tris.shape[0],), 0.5)
    sigma_true[np.linalg.norm(cent - [0.35, 0.2], axis=1) < 0.25] = 1.5
    args = (nodes, tris, forward_solve_oracle(nodes, tris, sigma_true, el,
                                              p.ex_mat, p.meas_mat),
            el, p.ex_mat, p.meas_mat)
    gauss_newton_absolute(*args, n_iter=1, device=dev)  # the first shapes
    loop, waits = inverse._gauss_newton, []

    def watched(*a, **kw):
        with chip_smoke.device_waits() as seen:
            out = loop(*a, **kw)
        waits.extend(seen)
        return out

    inverse._gauss_newton = watched
    try:
        sigma, res = gauss_newton_absolute(*args, n_iter=6, device=dev)
    finally:
        inverse._gauss_newton = loop
    assert waits == []
    want, want_res = gauss_newton_absolute(*args, n_iter=6, device="cpu")
    assert _rel_to_max(sigma, want) < 1e-3
    assert res[-1] < 0.2 * res[0]


def test_concurrent_requests_on_card_write_equal_dat(dev, tmp_path):
    """Three concurrent HTTP image requests and a direct call on the card
    (3 frames): the requests run at once (no lock) and the scatter is
    deterministic without a process-wide flag, so the four .dat files are
    byte-equal."""
    import json
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from eitx_torch.core.config import (
        ModelConfig,
        PipelineConfig,
        SimulationConfig,
    )
    from eitx_torch.io import to_png_bytes
    from eitx_torch.pipeline import Pipeline
    from eitx_torch.serve import EitxHTTPServer
    from eitx_torch.serve.client import zip_files_in_memory

    image = np.load(os.path.join(DATA, "torch_smoke_512.npz"))["image"]
    pipe = Pipeline(PipelineConfig(
        model=ModelConfig(axial_weights_512=os.path.join(
            ROOT, "weights", "tissue_n_512.msgpack")),
        sim=SimulationConfig(n_points=3), results_dir=str(tmp_path),
    ), device=dev)
    zipped = zip_files_in_memory([("slice.png", to_png_bytes(image))])
    srv = EitxHTTPServer(pipe, host="127.0.0.1", port=0)
    srv.start_background()

    def post():
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/uploadImageAxialSlice",
            data=zipped, headers={"Content-Type": "application/zip"},
            method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())

    try:
        with ThreadPoolExecutor(max_workers=3) as pool:
            answers = [f.result(timeout=600)
                       for f in [pool.submit(post) for _ in range(3)]]
    finally:
        srv.shutdown()
    answers.append(pipe.run_jpg_png(image))
    dats = [open(a["saved_file_name"], "rb").read() for a in answers]
    assert len({a["saved_file_name"] for a in answers}) == 4
    assert all(d == dats[0] for d in dats) and len(dats[0].splitlines()) == 36


def test_stiffness_assembly_never_waits_for_the_card(dev):
    """The Gauss-Newton loop assembles K every iteration: the deterministic
    scatter and the element geometry make the host wait for the card
    nowhere."""
    from eitx_torch.fem.assembly import assemble_stiffness

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from meshfix import disk_mesh

    nodes, tris = disk_mesh(48, 7)
    sigma = np.random.default_rng(4).uniform(0.1, 1.0, tris.shape[0])
    args = (torch.as_tensor(nodes, dtype=torch.float32, device=dev),
            torch.as_tensor(tris, device=dev),
            torch.as_tensor(sigma, dtype=torch.float32, device=dev),
            nodes.shape[0])
    want = assemble_stiffness(*args)
    with chip_smoke.device_waits() as waits:
        got = assemble_stiffness(*args)
    assert waits == []
    assert torch.equal(got, want)


def _tagged_store(n=4, imgsz=32):
    data = {
        "images": np.zeros((n, imgsz, imgsz, 3), np.uint8),
        "boxes": np.zeros((n, 2, 4), np.float32),
        "classes": np.zeros((n, 2), np.int32),
        "masks": np.zeros((n, 2, imgsz // 2, imgsz // 2), np.uint8),
        "valid": np.zeros((n, 2), bool),
    }
    for i in range(n):
        data["images"][i] = i
        data["masks"][i] = i
        data["boxes"][i, 0] = [i + 1.0, i + 2.0, i + 10.0, i + 20.0]
        data["valid"][i, 0] = True
    return data


def test_device_batches_on_card(dev):
    """The stream lives on the card, keeps the store's dtypes, flips
    boxes and masks with the image, and one seed gives one stream."""
    from eitx_torch.train.data import device_batches

    data = _tagged_store()
    it = device_batches(data, 3, seed=2, flip_h_prob=1.0, flip_v_prob=0.0,
                        device=dev)
    b = next(it)
    for k, v in b.items():
        assert v.device.type == "cuda" and v.dtype == torch.from_numpy(
            data[k]).dtype, k
    b = {k: v.cpu().numpy() for k, v in b.items()}
    for s in range(3):
        i = int(b["images"][s, 0, 0, 0])
        assert int(b["masks"][s, 0, 0, 0]) == i
        np.testing.assert_allclose(
            b["boxes"][s, 0], [32 - (i + 10.0), i + 2.0, 32 - (i + 1.0),
                               i + 20.0])
    runs = [[{k: v.cpu() for k, v in x.items()} for x, _ in zip(
        device_batches(data, 3, seed=5, mosaic_prob=0.5, mosaic_budget=6,
                       device=dev), range(3))] for _ in range(2)]
    for x, y in zip(*runs):
        assert all(torch.equal(x[k], y[k]) for k in x)


def _train_batch():
    from eitx_torch.train.data import synthetic_ct_batch

    return synthetic_ct_batch(2, 64, 4, seed=1)


TRAIN_CFG = dict(imgsz=64, variant="n", max_instances=4, warmup_steps=0,
                 total_steps=10, lr=5e-3, assigner="center")


def test_train_step_on_card_equals_cpu(dev):
    """One optimizer step of the YOLOv11-n segmenter at 64^2, batch 2,
    from the same initial parameters: the loss components within rtol
    1e-4 and the BatchNorm statistics within 1e-4 of their scale (float32
    convolutions in cuDNN's orders against oneDNN's, TF32 off)."""
    from eitx_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(**TRAIN_CFG)
    card, cpu = Trainer(cfg, device=dev), Trainer(cfg, device="cpu")
    m_card, m_cpu = card.train_step(_train_batch()), cpu.train_step(
        _train_batch())
    for k, v in m_cpu.items():
        assert abs(m_card[k] - v) <= 1e-4 * abs(v), (k, m_card[k], v)
    assert torch.backends.cudnn.allow_tf32 is False
    scale = max(float(t.abs().max()) for t in cpu.state.batch_stats.values())
    err = max(float((card.state.batch_stats[n].cpu() - t).abs().max())
              for n, t in cpu.state.batch_stats.items())
    assert err <= 1e-4 * scale


def _stream(dev):
    """A seeded device_batches stream of batches of 2 at 64^2."""
    from eitx_torch.train.data import device_batches, synthetic_ct_batch

    return device_batches(synthetic_ct_batch(8, 64, 4, seed=1), 2, seed=0,
                          device=dev)


def test_train_runs_from_one_seed_are_equal_on_card(dev):
    """Two trainers from one seed, each given 3 steps of its own stream of
    one seed, through fit: every parameter, batch statistic, Adam moment
    and EMA leaf equal to the bit (cuDNN's deterministic algorithms,
    eitx_torch.core.device)."""
    from eitx_torch.train import TrainConfig, Trainer
    from eitx_torch.train.trainer import fit

    assert torch.backends.cudnn.deterministic
    runs = []
    for _ in range(2):
        tr = Trainer(TrainConfig(**TRAIN_CFG), seed=0, device=dev)
        metrics, ema = fit(tr, _stream(dev), 3, log_every=0)
        runs.append((metrics, chip_smoke.state_digests(tr, ema)))
    (m_a, a), (m_b, b) = runs
    assert m_a == m_b and any(n.startswith("ema/") for n in a)
    assert not chip_smoke.digests_differ(a, b)


def test_train_checkpoint_round_trip_on_card(dev, tmp_path):
    """A .train file written on the card loads into a fresh trainer on the
    card equal on every tensor, and the resumed run continues the
    uninterrupted one to the bit: every leaf of state and the metrics
    equal after the resumed step and after the next."""
    from eitx_torch.train import TrainConfig, Trainer
    from eitx_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from eitx_torch.train.data import synthetic_ct_batch

    cfg = TrainConfig(**TRAIN_CFG)
    tr = Trainer(cfg, device=dev)
    for _ in range(2):
        tr.train_step(_train_batch())
    path = str(tmp_path / "card.train")
    save_checkpoint(path, tr.state)
    fresh = Trainer(cfg, seed=3, device=dev)
    fresh.state = load_checkpoint(path, fresh.state)
    for n, p in tr.state.params.items():
        assert torch.equal(fresh.state.params[n], p.detach())
        assert torch.equal(fresh.opt_state.nu[n], tr.opt_state.nu[n])
    for n, t in tr.state.batch_stats.items():
        assert torch.equal(fresh.state.batch_stats[n], t)
    assert (fresh.state.step, fresh.opt_state.count) == (2, 2)
    for step in range(2):
        batch = synthetic_ct_batch(2, 64, 4, seed=10 + step)
        assert fresh.train_step(batch) == tr.train_step(batch)
        assert not chip_smoke.digests_differ(
            chip_smoke.state_digests(fresh), chip_smoke.state_digests(tr))


@pytest.fixture
def nccl_world_of_one(dev, tmp_path):
    """A process group of this one card on NCCL, joined through a file;
    destroyed after the test."""
    import torch.distributed as dist

    from eitx_torch.parallel import init_distributed

    init_distributed(0, 1, str(tmp_path / "store"), "cuda")
    yield dev
    dist.destroy_process_group()


def test_mesh_trainer_on_card_equals_meshless(nccl_world_of_one):
    """Three steps on a (data, model) = (1, 1) mesh on NCCL against the
    meshless trainer from the same init and stream: the metrics of every
    step and every leaf of state after each step equal to the bit (a
    group of one computes the single-device step), and the state comes
    back whole."""
    from eitx_torch.parallel import make_device_mesh
    from eitx_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(**TRAIN_CFG)
    mesh = make_device_mesh(("data", "model"), (1, 1))
    plain = Trainer(cfg, device=nccl_world_of_one)
    sharded = Trainer(cfg, mesh=mesh, device=nccl_world_of_one)
    s_plain, s_mesh = _stream(nccl_world_of_one), _stream(nccl_world_of_one)
    for _ in range(3):
        a, b = sharded.train_step(next(s_mesh)), plain.train_step(
            next(s_plain))
        assert a == b
        assert not chip_smoke.digests_differ(
            chip_smoke.state_digests(sharded),
            chip_smoke.state_digests(plain))
    st = sharded.state
    assert all(tuple(st.params[n].shape) == tuple(p.shape)
               for n, p in plain.state.params.items())


def test_sharded_monitoring_and_group_solve_on_card(nccl_world_of_one):
    """sharded_eit_monitoring and sharded_group_solve on a world of one
    card: equal to forward_solve_batched and to each subject's solve; the
    blocks of frames that the ranks of a larger world solve equal the
    whole call's frames."""
    from eitx_torch.fem import (
        ClassStiffness,
        LowRankSpectralSolver,
        create_protocol,
        forward_solve_batched,
        place_electrodes_equal_spacing,
    )
    from eitx_torch.fem import solver
    from eitx_torch.mesh.triangulate import triangulate_polygon
    from eitx_torch.parallel import (
        make_device_mesh,
        sharded_eit_monitoring,
        sharded_group_solve,
    )
    from eitx_torch.parallel.shard import monitoring_block

    whole_bytes = solver.SOLVE_STACK_BYTES
    dev = nccl_world_of_one
    fmesh = make_device_mesh(("data",))
    proto = create_protocol(16, 1, 1, "std")
    systems = []
    for k in range(3):
        th = np.linspace(0, 2 * np.pi, 48, endpoint=False)
        poly = np.stack([100 + (80 + k) * np.cos(th),
                         100 + 70 * np.sin(th)], 1)
        nodes, tris = triangulate_polygon(poly, lc=12)
        cls = np.ones(tris.shape[0], dtype=np.int64)
        cls[np.linalg.norm(nodes[tris].mean(1) - [80, 100], axis=1) < 25] = 2
        systems.append((ClassStiffness.build(
            nodes, tris, cls, n_classes=5, pad_nodes_to=128,
            pad_elems_to=256, device=dev),
            place_electrodes_equal_spacing(nodes, tris, 16,
                                           starting_angle=np.pi)))
    sigma = np.tile([0.006, 0.35, 0.15, 0.017, 0.4], (6, 1))
    sigma[:, 2] = np.linspace(0.06, 0.18, 6)
    cs, el = systems[0]
    whole = forward_solve_batched(cs, sigma, el, proto.ex_mat, proto.meas_mat)
    assert torch.equal(
        sharded_eit_monitoring(cs, sigma, el, proto.ex_mat, proto.meas_mat,
                               mesh=fmesh), whole)
    # every rank's block of a larger world, solved in the single call's
    # stacks (one of 6 frames, then stacks of 4: [0, 4), [4, 6) + 2): the
    # same bits
    for stack_frames in (6, 4):
        solver.SOLVE_STACK_BYTES = (stack_frames * cs.n_nodes ** 2
                                    * cs.k_class.element_size())
        try:
            want = forward_solve_batched(cs, sigma, el, proto.ex_mat,
                                         proto.meas_mat)
            for size in (2, 3, 4, 6):
                got = torch.cat([monitoring_block(
                    cs, sigma, el, proto.ex_mat, proto.meas_mat, r, size)
                    for r in range(size)])[:6]
                assert torch.equal(got, want), (stack_frames, size)
        finally:
            solver.SOLVE_STACK_BYTES = whole_bytes
    solvers = LowRankSpectralSolver.build_batch(
        [s[0] for s in systems], sigma[0], 2, [s[1] for s in systems],
        proto.ex_mat, proto.meas_mat, [0.12] * 3)
    alphas = sigma[:, 2]
    for s, v in zip(solvers, sharded_group_solve(solvers, alphas, fmesh)):
        assert torch.equal(v, s.solve(alphas))


@pytest.mark.parametrize("host_ops", [False, True],
                         ids=["card_alone", "card_and_host"])
def test_train_spans_time_the_card_outside_its_busy_time(dev, host_ops):
    """Under the benchmark's profiler, of the card's activity alone as the
    training cell records it or of the host's operators too, the spans
    record: each phase of two steps carries device seconds, and no range
    of the program counts as the card's work in the benchmark's trace."""
    from benchmark.lib.trace import Trace, profile
    from eitx_torch.core import timing
    from eitx_torch.train import TrainConfig, Trainer
    from eitx_torch.train.trainer import EMA

    tr = Trainer(TrainConfig(**dict(TRAIN_CFG, assigner="tal")), device=dev)
    ema = EMA(tr.local_params())
    batch = _train_batch()
    tr.train_step(batch, device_metrics=True)
    torch.cuda.synchronize()
    timing.clear()
    with profile(host_ops) as prof:
        assert torch.autograd._profiler_enabled()
        for _ in range(2):
            tr.train_step(batch, device_metrics=True)
            ema.update(tr.local_params())
        torch.cuda.synchronize()
    spans, _ = timing.recorded()
    timing.clear()
    for phase in ("step", "forward", "loss", "assign", "backward", "update",
                  "ema"):
        s = spans[f"eitx.train.{phase}"]
        assert s["calls"] == 2 and s["device_s"] > 0, (phase, s)
    assert spans["eitx.train.step"]["device_s"] > \
        spans["eitx.train.backward"]["device_s"]
    device = Trace(prof).device
    assert device
    assert not [n for _, _, n in device if n.startswith("eitx.")]


def test_fem_spans_of_a_cell_thorax(dev):
    """One request of the FEM cells' configuration on a thorax of their
    pool, traced as those cells trace it: bit-equal voltages, one subject,
    9.4-10.5 MB uploaded (the lung selector alone is 3,072 x 768 float32,
    9.44 MB), device seconds in the factorisation, and no range of the
    program among the card's work."""
    import json

    from benchmark.inputs.thorax import subject_pool
    from benchmark.lib.trace import Trace, profile
    from eitx_torch.core import timing
    from eitx_torch.core.config import SimulationConfig
    from eitx_torch.fem import simulate_eit_monitoring

    with open(os.path.join(ROOT, "benchmark", "configs",
                           "thorax-lc7-e16.json")) as fh:
        cfg = json.load(fh)
    mesh = subject_pool(cfg["geometry"], 0.03, 1, 2147483659)[0]
    sim = SimulationConfig(**cfg["simulation"])
    plain, _ = simulate_eit_monitoring(mesh, sim, device=dev)
    timing.clear()
    with profile(True) as prof:
        traced, _ = simulate_eit_monitoring(mesh, sim, device=dev)
    spans, counters = timing.recorded()
    timing.clear()
    assert np.array_equal(plain, traced)
    assert counters["eitx.fem.subjects"] == 1
    assert 9.4e6 <= counters["eitx.fem.upload_bytes"] <= 10.5e6, counters
    for stage in ("assembly", "setup.factor", "solve"):
        assert spans[f"eitx.fem.{stage}"]["device_s"] > 0, stage
    device = Trace(prof).device
    assert device
    assert not [n for _, _, n in device if n.startswith("eitx.")]
