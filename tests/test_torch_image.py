"""CT preprocessing of the port against eitx on the CPU: HU transform,
windowing, min-max normalization, morphology, largest component, hole
fill, body mask (all exact) and the frontal reslice."""

import functools

import numpy as np
import pytest
import torch

from eitx import image as ref
from eitx.image.orientation import axial_stack_to_frontal as ref_frontal
from eitx.image.orientation import middle_frontal_slice as ref_middle
from eitx.image.orientation import stack_axial_slices as ref_stack
from eitx.train.phantoms import thorax_phantom_hu
from eitx_torch import image as port
from eitx_torch.image.orientation import (
    axial_stack_to_frontal,
    middle_frontal_slice,
    stack_axial_slices,
)
from torch_bounds import bounded


def _np(t):
    assert isinstance(t, torch.Tensor)
    return t.numpy()


# ------------------------------------------------------------------ HU, window
@pytest.mark.parametrize("dtype,slope,intercept", [
    (np.uint16, 1.0, -1024.0), (np.int16, 1.0, -1024.0),
    (np.int16, 0.5, 12.25), (np.float32, 1.7, -3.3), (np.float64, 1.0, 0.0),
])
def test_hu_transform_matches_eitx(dtype, slope, intercept, record_property):
    rng = np.random.default_rng(0)
    px = rng.integers(0, 4000, (3, 32, 32)).astype(dtype)
    want = np.asarray(ref.hu_transform(px, slope, intercept))
    got = _np(port.hu_transform(px, slope, intercept, device="cpu"))
    assert got.dtype == np.float32 and got.shape == want.shape
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    bounded(record_property, "max_rel", rel.max(), "<=", 1e-6)


def test_hu_transform_known_values():
    px = np.array([[0, 1000], [2000, 65000]], dtype=np.uint16)
    hu = _np(port.hu_transform(px, 1.0, -1024.0, device="cpu"))
    assert hu[0, 0] == -1024 and hu[1, 1] == 63976  # uint16 is not wrapped


@pytest.mark.parametrize("level,width,rotate", [
    (40.0, 400.0, True), (40.0, 400.0, False), (-600.0, 1500.0, True),
    (40.5, 399.0, True), (30.0, 351.5, True),
])
def test_window_normalize_exact(level, width, rotate):
    rng = np.random.default_rng(1)
    vol = rng.uniform(-1100, 1100, (4, 48, 40)).astype(np.float32)
    vol[0, 0, :4] = [level - width // 2, level + width // 2, level, 1e6]
    want = np.asarray(ref.window_normalize(vol, level, width, rotate))
    got = _np(port.window_normalize(vol, level, width, rotate, device="cpu"))
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)
    one = _np(port.window_normalize(vol[2], level, width, rotate,
                                    device="cpu"))
    assert np.array_equal(one, got[2])


def test_window_normalize_takes_integer_pixels():
    sl = np.random.default_rng(2).integers(-1000, 1000, (32, 32)).astype(
        np.int16)
    assert np.array_equal(_np(port.window_normalize(sl, device="cpu")),
                          np.asarray(ref.window_normalize(sl)))


@pytest.mark.parametrize("case", ["random", "halves", "constant", "int16"])
def test_minmax_normalize_u8_exact(case):
    rng = np.random.default_rng(3)
    if case == "random":
        x = rng.normal(0, 300, (64, 80)).astype(np.float32)
    elif case == "halves":  # every value lands on k + 0.5: half to even
        x = np.arange(511, dtype=np.float32).reshape(7, 73)  # x / 2
    elif case == "constant":
        x = np.full((8, 8), 7.0, np.float32)
    else:
        x = rng.integers(-400, 700, (96, 64)).astype(np.int16)
    want = np.asarray(ref.minmax_normalize_u8(x))
    got = _np(port.minmax_normalize_u8(x, device="cpu"))
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)


# ------------------------------------------------------------------ the masks
def _adversarial_masks(s=48):
    """The hand-built masks of tests/test_cv2_golden.py: spur, diagonal
    chain, border frame, several blobs, ring."""
    masks = []
    m = np.zeros((s, s), np.uint8)
    m[10:30, 10:30] = 1
    m[20, 30:44] = 1
    masks.append(m)
    m = np.zeros((s, s), np.uint8)
    for i in range(5, 40):
        m[i, i] = 1
    masks.append(m)
    m = np.zeros((s, s), np.uint8)
    m[0, :] = m[-1, :] = 1
    m[:, 0] = m[:, -1] = 1
    masks.append(m)
    m = np.zeros((s, s), np.uint8)
    m[5:12, 5:12] = 1
    m[30:44, 8:20] = 1
    m[8, 40] = 1
    m[40, 40:43] = 1
    masks.append(m)
    m = np.zeros((s, s), np.uint8)
    yy, xx = np.mgrid[0:s, 0:s]
    r2 = (yy - s / 2) ** 2 + (xx - s / 2) ** 2
    m[(r2 < 300) & (r2 > 100)] = 1
    masks.append(m)
    return masks


def _test_image_masks():
    """The inputs of tests/test_image.py's mask cases."""
    a = np.zeros((32, 32), bool)
    a[5:25, 5:25] = True
    a[1, 1] = True
    b = np.zeros((16, 16), bool)
    b[4:12, 4:12] = True
    c = np.zeros((40, 40), bool)
    c[2:6, 2:6] = True
    c[10:30, 10:30] = True
    d = np.zeros((30, 30), bool)
    d[5:25, 5:25] = True
    d[10:15, 10:15] = False
    d[0:3, 0:3] = False
    return [a, b, c, d]


@functools.lru_cache(maxsize=None)
def _battery():
    """Per-class masks of pseudo-labeled thorax phantoms (the battery of
    tests/test_cv2_golden.py), the hand-built masks, the test_image cases
    and seeded speckle."""
    from eitx.scripts.pseudo_label import pseudo_label_slice

    rng = np.random.default_rng(3)
    out = []
    for _ in range(3):
        hu, body = thorax_phantom_hu(rng, 128, rich=True)
        labels = np.asarray(pseudo_label_slice(hu, body))
        out += [labels == cid for cid in range(4) if (labels == cid).any()]
        out.append(body > 0)
    out += [m > 0 for m in _adversarial_masks()]
    out += _test_image_masks()
    out.append(np.random.default_rng(9).random((40, 56)) > 0.55)
    return tuple(out)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("name", ["binary_dilate", "binary_erode",
                                  "binary_open", "binary_close"])
def test_morphology_exact(name, k):
    for m in _battery():
        want = np.asarray(getattr(ref, name)(m, k))
        got = _np(getattr(port, name)(m, k, device="cpu"))
        assert got.dtype == np.bool_
        assert np.array_equal(got, want), name
    stack = np.stack([m for m in _battery() if m.shape == (128, 128)][:4])
    want = np.asarray(getattr(ref, name)(stack, k))
    assert np.array_equal(
        _np(getattr(port, name)(stack, k, device="cpu")), want)


def test_morphology_takes_0_255_masks():
    m = _battery()[0].astype(np.uint8) * 255
    assert np.array_equal(_np(port.binary_open(m, 5, device="cpu")),
                          np.asarray(ref.binary_open(m, 5)))


def test_largest_component_exact_on_the_battery():
    for m in _battery():
        want = np.asarray(ref.largest_component(m))
        assert np.array_equal(_np(port.largest_component(m, device="cpu")),
                              want)


def _two_equal_components():
    m = np.zeros((24, 24), bool)
    m[2:6, 2:8] = True     # 24 px, the lesser root index
    m[12:18, 10:14] = True  # 24 px
    m[20:22, 20:22] = True  # 4 px
    return m


@pytest.mark.parametrize("flip", [False, True])
def test_largest_component_ties_keep_the_least_root(flip):
    m = _two_equal_components()
    if flip:
        m = m[::-1, ::-1].copy()
    want = np.asarray(ref.largest_component(m))
    got = _np(port.largest_component(m, device="cpu"))
    assert got.sum() == 24
    assert np.array_equal(got, want)


def test_largest_component_of_an_empty_mask_is_empty():
    m = np.zeros((16, 20), bool)
    got = _np(port.largest_component(m, device="cpu"))
    assert not got.any()
    assert np.array_equal(got, np.asarray(ref.largest_component(m)))
    corner = m.copy()
    corner[0, 0] = True  # the component whose root index is 0
    assert np.array_equal(_np(port.largest_component(corner, device="cpu")),
                          corner)


def test_fill_holes_exact_on_the_battery():
    for m in _battery():
        want = np.asarray(ref.fill_holes(m))
        assert np.array_equal(_np(port.fill_holes(m, device="cpu")), want)


def test_fill_holes_keeps_diagonal_leaks_closed():
    m = np.zeros((12, 12), bool)  # a diamond outline: 8-connected ring
    for i in range(5):
        m[1 + i, 5 - i] = m[1 + i, 5 + i] = True
        m[9 - i, 5 - i] = m[9 - i, 5 + i] = True
    want = np.asarray(ref.fill_holes(m))
    got = _np(port.fill_holes(m, device="cpu"))
    assert got[5, 5] and np.array_equal(got, want)


def _hu_cases():
    rng = np.random.default_rng(7)
    cases = []
    for i in range(4):  # the inputs of the cv2 body-mask chain case
        hu, _ = thorax_phantom_hu(rng, 160, rich=(i % 2 == 0))
        hu[150:156, 20:140] = 200.0  # CT-table strip
        cases.append(hu)
    hu = np.full((64, 64), -1000.0)  # tests/test_image.py's case
    hu[10:50, 10:50] = 40.0
    hu[20:30, 20:30] = -800.0
    hu[60:63, 60:63] = 50.0
    cases.append(hu)
    cases.append(np.full((32, 32), -1000.0))  # no body at all
    return cases


@pytest.mark.parametrize("flipud", [False, True])
def test_body_mask_from_hu_exact(flipud):
    for hu in _hu_cases():
        want = np.asarray(ref.body_mask_from_hu(hu, flipud=flipud))
        got = _np(port.body_mask_from_hu(hu, flipud=flipud, device="cpu"))
        assert got.dtype == np.uint8
        assert set(np.unique(got)) <= {0, 255}
        assert np.array_equal(got, want)


def test_body_mask_thresholds_and_kernel_are_honoured():
    hu = _hu_cases()[0]
    want = np.asarray(ref.body_mask_from_hu(hu, -300.0, 200.0, 3))
    got = _np(port.body_mask_from_hu(hu, -300.0, 200.0, 3, device="cpu"))
    assert np.array_equal(got, want)


def test_image_functions_default_to_the_card():
    t = torch.zeros((8, 8))
    # a tensor is used where it lives; numpy input goes to `device`
    assert port.body_mask_from_hu(t).device.type == "cpu"
    assert port.window_normalize(t).device.type == "cpu"
    if not torch.cuda.is_available():
        for fn in (port.body_mask_from_hu, port.window_normalize,
                   port.hu_transform, port.minmax_normalize_u8,
                   port.binary_open, port.fill_holes, port.largest_component):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                fn(np.zeros((8, 8)))


# ------------------------------------------------------------------ orientation
@pytest.mark.parametrize("position", ["HFS", "FFS", "HFP"])
@pytest.mark.parametrize("orientation", [
    None, (1, 0, 0, 0, 1, 0), (-1, 0, 0, 0, 1, 0), (1, 0, 0, 0, -1, 0),
    (-1, 0, 0, 0, -1, 0),
])
@pytest.mark.parametrize("patient", [None, ("L", "P"), ("R", "P"),
                                     ("L", "A"), ("L",)])
def test_axial_stack_to_frontal_exact(position, orientation, patient):
    slices = [np.random.default_rng(i).integers(0, 100, (5, 6)).astype(
        np.int16) for i in range(4)]
    vol = stack_axial_slices(slices)
    assert np.array_equal(vol, ref_stack(slices))
    got = axial_stack_to_frontal(vol, position, orientation, patient)
    want = ref_frontal(vol, position, orientation, patient)
    assert np.array_equal(got, want)
    assert np.array_equal(middle_frontal_slice(got), ref_middle(want))


def _same_shape_stacks():
    """The battery's masks stacked by shape: the first four of each shape
    that has two or more."""
    groups = {}
    for m in _battery():
        groups.setdefault(m.shape, []).append(m)
    return [np.stack(v[:4]) for v in groups.values() if len(v) > 1]


@pytest.mark.parametrize("name", ["label_components", "largest_component",
                                  "fill_holes"])
def test_batch_forms_equal_eitx_and_each_image(name):
    """The ``*_batch`` forms (eitx's ``jax.vmap``s) equal eitx's on every
    pixel, and the port's single-image function on each image."""
    from eitx.image import cc as ref_cc

    stacks = _same_shape_stacks()
    assert len(stacks) >= 2
    for stack in stacks:
        want = np.asarray(getattr(ref_cc, f"{name}_batch")(stack))
        got = _np(getattr(port, f"{name}_batch")(stack, device="cpu"))
        assert got.shape == stack.shape and np.array_equal(got, want)
        for m, one in zip(stack, got):
            assert np.array_equal(
                one, _np(getattr(port, name)(m, device="cpu")))


@pytest.mark.parametrize("flipud", [False, True])
def test_body_mask_from_hu_batch_exact(flipud):
    stack = np.stack([hu for hu in _hu_cases() if hu.shape == (160, 160)])
    stack = stack[:2] if flipud else stack[2:]  # rich and plain phantoms
    from eitx.image.bodymask import body_mask_from_hu_batch

    want = np.asarray(body_mask_from_hu_batch(stack, flipud=flipud))
    got = _np(port.body_mask_from_hu_batch(stack, flipud=flipud,
                                           device="cpu"))
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    for hu, one in zip(stack, got):
        assert np.array_equal(one, _np(port.body_mask_from_hu(
            hu, flipud=flipud, device="cpu")))
