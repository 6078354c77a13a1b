"""The port's training data against eitx's: the same seeds give equal
phantoms, pseudo-labels and synthetic batches, and the device-resident
batch stream gives eitx's batches for the same seed (the same threefry
draws, eitx_torch/core/prng.py; tolerance none: every element equal). The
stream also keeps the semantics of tests/test_train.py and its
determinism."""

import numpy as np
import pytest
import torch

import eitx.scripts.pseudo_label as jax_labels
import eitx.train.data as jax_data
import eitx.train.phantoms as jax_phantoms
import eitx_torch.scripts.pseudo_label as port_labels
import eitx_torch.train.data as port_data
import eitx_torch.train.phantoms as port_phantoms

CPU = "cpu"


def _equal_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "raw_boxes":
            assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k]))
            continue
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_synthetic_ct_batch_equal():
    _equal_batches(jax_data.synthetic_ct_batch(3, 64, 6, seed=4),
                   port_data.synthetic_ct_batch(3, 64, 6, seed=4))


PHANTOM_FORMS = {
    "plain": dict(),
    "rich": dict(rich=True),
    "anatomy_frac": dict(anatomy_frac=0.5, max_instances=40),
    "wide_pose": dict(wide_pose=True, anatomy_frac=1.0),
    "pv_sigma_max": dict(pv_sigma_max=2.0, rich=True),
    "geometry_frac": dict(geometry_frac=0.6, imgsz=128),
    "store_u8_mask_res": dict(store_u8=True, mask_res=32),
}


@pytest.mark.parametrize("form", sorted(PHANTOM_FORMS))
def test_phantom_batch_equal(form):
    """Equal images, boxes, classes, masks, valid and label images for
    the same seed (the labeller on the CPU here)."""
    kw = dict(PHANTOM_FORMS[form])
    imgsz = kw.pop("imgsz", 64)
    mi = kw.pop("max_instances", 12)
    want = jax_phantoms.phantom_batch(3, imgsz, mi, np.random.default_rng(5),
                                      return_labels=True, **kw)
    got = port_phantoms.phantom_batch(3, imgsz, mi, np.random.default_rng(5),
                                      return_labels=True, device=CPU, **kw)
    _equal_batches(want, got)
    assert got["valid"].any()


@pytest.mark.parametrize("hard_frac", [0.0, 0.5])
def test_rib_batch_equal(hard_frac):
    kw = dict(return_boxes=True, hard_frac=hard_frac)
    _equal_batches(
        jax_phantoms.rib_batch(3, 128, 24, np.random.default_rng(2), **kw),
        port_phantoms.rib_batch(3, 128, 24, np.random.default_rng(2), **kw))


@pytest.mark.parametrize("kw", [dict(), dict(hard=True), dict(n_pairs=0),
                                dict(n_pairs=5, hard=True)])
def test_frontal_rib_phantom_equal(kw):
    a = jax_phantoms.frontal_rib_phantom(np.random.default_rng(9), 96, **kw)
    b = port_phantoms.frontal_rib_phantom(np.random.default_rng(9), 96, **kw)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(y, x)


def test_thorax_and_geometry_hu_equal():
    for kw in (dict(), dict(rich=True), dict(anatomy=True),
               dict(anatomy=True, wide_pose=True)):
        a = jax_phantoms.thorax_phantom_hu(np.random.default_rng(1), 96, **kw)
        b = port_phantoms.thorax_phantom_hu(np.random.default_rng(1), 96, **kw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    a = jax_phantoms.geometry_slice_hu(np.random.default_rng(2), 128)
    b = port_phantoms.geometry_slice_hu(np.random.default_rng(2), 128)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    for gid in (1, 6):  # eval-reserved geometries are refused
        with pytest.raises(ValueError):
            port_phantoms._train_geometry_polygons(gid)


def test_pseudo_labels_equal():
    """pseudo_label_slice (also at a scaled HU table), the batched
    pseudo_label_stack and the YOLO label lines traced from the labels."""
    rng = np.random.default_rng(3)
    hus, bodies = [], []
    for kw in (dict(), dict(rich=True), dict(anatomy=True)):
        hu, body = jax_phantoms.thorax_phantom_hu(rng, 96, **kw)
        hus.append(hu)
        bodies.append(body)
        want = jax_labels.pseudo_label_slice(hu, body)
        got = port_labels.pseudo_label_slice(hu, body, device=CPU)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            port_labels.pseudo_label_slice(hu, body, 1.1, device=CPU),
            jax_labels.pseudo_label_slice(hu, body, 1.1))
        assert (port_labels.labels_to_yolo_lines(got)
                == jax_labels.labels_to_yolo_lines(want))
    np.testing.assert_array_equal(
        port_labels.pseudo_label_stack(np.stack(hus), np.stack(bodies),
                                       device=CPU),
        jax_labels.pseudo_label_stack(np.stack(hus), np.stack(bodies)))


# --- device_batches ----------------------------------------------------------

def _tagged_store(n=4, imgsz=32):
    data = {
        "images": np.zeros((n, imgsz, imgsz, 3), np.uint8),
        "boxes": np.zeros((n, 2, 4), np.float32),
        "classes": np.zeros((n, 2), np.int32),
        "masks": np.zeros((n, 2, imgsz // 2, imgsz // 2), np.uint8),
        "valid": np.zeros((n, 2), bool),
    }
    for i in range(n):
        data["images"][i] = i  # flip-invariant sample tag
        data["masks"][i] = i
        data["boxes"][i, 0] = [i + 1.0, i + 2.0, i + 10.0, i + 20.0]
        data["valid"][i, 0] = True
    return data


def _np(b):
    return {k: v.cpu().numpy() for k, v in b.items()}


def test_device_batches_shapes_dtypes_and_flip_coherence():
    """tests/test_train.py's contract on the port: keys, dtypes and shapes
    of the store; a gather of exact samples without augmentation; forced
    flips mirror boxes and masks coherently and keep invalid slots 0; a
    detection-only store works."""
    n, imgsz, bs = 4, 32, 3
    data = _tagged_store(n, imgsz)
    b = _np(next(port_data.device_batches(data, bs, seed=1, augment=False,
                                          device=CPU)))
    assert set(b) == set(data)
    for k in data:
        assert b[k].dtype == data[k].dtype, k
        assert b[k].shape == (bs,) + data[k].shape[1:], k
    for s in range(bs):
        i = int(b["images"][s, 0, 0, 0])
        for k in data:
            np.testing.assert_array_equal(b[k][s], data[k][i])
    b = _np(next(port_data.device_batches(data, bs, seed=2, flip_h_prob=1.0,
                                          flip_v_prob=0.0, device=CPU)))
    for s in range(bs):
        i = int(b["images"][s, 0, 0, 0])
        assert int(b["masks"][s, 0, 0, 0]) == i
        exp = [imgsz - (i + 10.0), i + 2.0, imgsz - (i + 1.0), i + 20.0]
        np.testing.assert_allclose(b["boxes"][s, 0], exp)
        np.testing.assert_array_equal(b["boxes"][s, 1], 0.0)
    b = _np(next(port_data.device_batches(data, bs, seed=2, flip_h_prob=0.0,
                                          flip_v_prob=1.0, device=CPU)))
    for s in range(bs):
        i = int(b["images"][s, 0, 0, 0])
        exp = [i + 1.0, imgsz - (i + 20.0), i + 10.0, imgsz - (i + 2.0)]
        np.testing.assert_allclose(b["boxes"][s, 0], exp)
    det = {k: v for k, v in data.items() if k != "masks"}
    b = next(port_data.device_batches(det, bs, seed=3, device=CPU))
    assert "masks" not in b and b["images"].shape[0] == bs


def test_device_batches_flip_moves_pixels_with_boxes():
    """A bright square and its box and mask flip together."""
    data = _tagged_store(1, 32)
    data["images"][0] = 0
    data["images"][0, 4:10, 2:8] = 200
    data["masks"][0, 0] = 0
    data["masks"][0, 0, 2:5, 1:4] = 255
    data["boxes"][0, 0] = [2.0, 4.0, 8.0, 10.0]
    b = _np(next(port_data.device_batches(data, 1, seed=0, flip_h_prob=1.0,
                                          flip_v_prob=1.0, device=CPU)))
    x1, y1, x2, y2 = b["boxes"][0, 0].astype(int)
    assert (x1, y1, x2, y2) == (24, 22, 30, 28)
    assert (b["images"][0, y1:y2, x1:x2] == 200).all()
    assert b["images"][0].astype(int).sum() == 200 * 36 * 3
    assert (b["masks"][0, 0, y1 // 2:y2 // 2, x1 // 2:x2 // 2] == 255).all()


def test_device_batches_mosaic_composition_and_budget():
    """tests/test_train.py's mosaic test on the port: with a one-sample
    store, quadrants are the 2x2-mean downscale, boxes are scaled and
    offset per quadrant, masks land in one mask-canvas quadrant, and the
    widened budget pads with invalid slots."""
    imgsz, bs, I = 32, 2, 3
    rng = np.random.default_rng(7)
    data = {
        "images": rng.integers(0, 255, (1, imgsz, imgsz, 3)).astype(np.uint8),
        "boxes": np.zeros((1, I, 4), np.float32),
        "classes": np.asarray([[2, 1, 0]], np.int32),
        "masks": np.zeros((1, I, imgsz // 2, imgsz // 2), np.uint8),
        "valid": np.asarray([[True, True, False]], bool),
    }
    data["boxes"][0, 0] = [4.0, 6.0, 20.0, 28.0]
    data["boxes"][0, 1] = [10.0, 2.0, 30.0, 12.0]
    data["masks"][0, 0, 3:11, 2:10] = 255
    data["masks"][0, 1, 1:6, 5:15] = 128
    budget = 4 * I
    b = _np(next(port_data.device_batches(data, bs, seed=5, augment=False,
                                          mosaic_prob=1.0,
                                          mosaic_budget=budget, device=CPU)))
    assert b["images"].shape == (bs, imgsz, imgsz, 3)
    assert b["boxes"].shape == (bs, budget, 4)
    small = data["images"][0].reshape(imgsz // 2, 2, imgsz // 2, 2, 3).astype(
        np.float32).mean((1, 3))
    small = np.round(small).astype(np.uint8)
    h = imgsz // 2
    for (r0, c0) in ((0, 0), (0, h), (h, 0), (h, h)):
        np.testing.assert_array_equal(b["images"][0, r0:r0 + h, c0:c0 + h],
                                      small)
    val = b["valid"][0]
    assert val.sum() == 8
    expect = set()
    for ox, oy in ((0, 0), (h, 0), (0, h), (h, h)):
        for i in (0, 1):
            x1, y1, x2, y2 = data["boxes"][0, i] * 0.5
            expect.add((x1 + ox, y1 + oy, x2 + ox, y2 + oy))
    assert {tuple(np.round(bx, 3)) for bx in b["boxes"][0][val]} == expect
    np.testing.assert_array_equal(b["boxes"][0][~val], 0.0)
    r2 = imgsz // 4
    for m in b["masks"][0][val]:
        quads = [m[:r2, :r2], m[:r2, r2:], m[r2:, :r2], m[r2:, r2:]]
        assert sum(q.any() for q in quads) == 1


def test_device_batches_mosaic_budget_keeps_valid_first():
    """Over budget, valid candidates fill the budget before invalid ones."""
    data = _tagged_store(4, 32)
    data["valid"][:] = True
    b = _np(next(port_data.device_batches(data, 3, seed=1, augment=False,
                                          mosaic_prob=1.0, mosaic_budget=5,
                                          device=CPU)))
    assert b["valid"].shape == (3, 5) and b["valid"].all()


def test_device_batches_stream_is_deterministic():
    """The same seed gives the same stream; another seed another;
    mosaic_prob=0 gives the stream drawn without the option."""
    data = port_phantoms.phantom_batch(6, 64, 5, np.random.default_rng(1),
                                       store_u8=True, device=CPU)

    def stream(seed, k=3, **kw):
        it = port_data.device_batches(data, 4, seed=seed, device=CPU, **kw)
        return [_np(next(it)) for _ in range(k)]

    a, b = stream(9), stream(9)
    for x, y in zip(a, b):
        _equal_batches(x, y)
    assert any(not np.array_equal(x["images"], y["images"])
               for x, y in zip(a, stream(10)))
    for x, y in zip(a, stream(9, mosaic_prob=0.0)):
        _equal_batches(x, y)
    m1 = stream(9, mosaic_prob=0.5, mosaic_budget=12)
    m2 = stream(9, mosaic_prob=0.5, mosaic_budget=12)
    for x, y in zip(m1, m2):
        _equal_batches(x, y)
        assert x["boxes"].shape == (4, 12, 4)


def _u8_store(n, imgsz, max_instances, seed):
    """synthetic_ct_batch as a training store: uint8 images and masks."""
    d = jax_data.synthetic_ct_batch(n, imgsz, max_instances, seed=seed)
    d["images"] = np.round(d["images"] * 255).astype(np.uint8)
    d["masks"] = np.round(d["masks"] * 255).astype(np.uint8)
    return d


@pytest.mark.parametrize("mosaic", [0.0, 0.5], ids=["plain", "mosaic"])
@pytest.mark.parametrize("augment", [True, False], ids=["aug", "noaug"])
def test_device_batches_match_eitx(mosaic, augment):
    """The first 4 batches of one seed: eitx's stream and the port's, every
    element of every key equal (gathers, flips, the mosaic's canvas, its
    budget selection with ties broken as top_k breaks them)."""
    store = _u8_store(8, 64, 4, seed=3)
    kw = dict(seed=21, augment=augment, mosaic_prob=mosaic,
              mosaic_budget=10 if mosaic else 0)
    want = jax_data.device_batches(store, 4, **kw)
    got = port_data.device_batches(store, 4, device=CPU, **kw)
    for _ in range(4):
        _equal_batches({k: np.asarray(v) for k, v in next(want).items()},
                       _np(next(got)))


def test_device_batches_match_eitx_across_draw_blocks():
    """The port draws a block of steps at a time on the host: the steps on
    both sides of a block's end are eitx's too."""
    store = _u8_store(5, 32, 4, seed=4)
    kw = dict(seed=8, mosaic_prob=0.5, mosaic_budget=8)
    want = jax_data.device_batches(store, 2, **kw)
    got = port_data.device_batches(store, 2, device=CPU, **kw)
    for step in range(port_data._DRAW_BLOCK + 2):
        a, b = next(want), next(got)
        if step >= port_data._DRAW_BLOCK - 2:
            _equal_batches({k: np.asarray(v) for k, v in a.items()}, _np(b))
