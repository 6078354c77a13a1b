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
