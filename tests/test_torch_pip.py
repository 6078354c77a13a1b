"""Point-in-polygon: the port's plain version and wrapper against eitx.
The CUDA kernel itself is tested on the card in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from eitx.mesh.classify import _points_in_polys
from eitx.mesh.pallas_pip import points_in_polys_pallas
from eitx_torch.mesh import pip
from torch_bounds import bounded


def _square_and_triangle():
    sq = np.array([[10, 10], [90, 10], [90, 90], [10, 90]], float)
    tri = np.array([[120, 20], [180, 20], [150, 80]], float)
    polys = np.zeros((2, 8, 2))
    polys[0, :4] = sq
    polys[0, 4:] = sq[-1]
    polys[1, :3] = tri
    polys[1, 3:] = tri[-1]
    return polys


KNOWN_PTS = np.array([[5.0, 5.0], [15.0, 5.0], [-1.0, 3.0], [9.9, 9.9]])
KNOWN_SQ = np.array([[[0, 0], [10, 0], [10, 10], [0, 10]]], float)


@pytest.mark.parametrize("reference", ["pallas_interpret", "jnp"])
def test_plain_version_matches_eitx_on_random_points(reference, record_property):
    rng = np.random.default_rng(0)
    polys = _square_and_triangle()
    pts = rng.uniform(0, 200, (3000, 2))
    pj, qj = jnp.asarray(pts, jnp.float32), jnp.asarray(polys, jnp.float32)
    if reference == "jnp":
        ref = np.asarray(_points_in_polys(pj, qj))
    else:
        ref = np.asarray(points_in_polys_pallas(pj, qj, interpret=True))
    got = pip.points_in_polys_ref(
        torch.as_tensor(pts, dtype=torch.float32),
        torch.as_tensor(polys, dtype=torch.float32),
    ).numpy()
    assert got.shape == ref.shape
    record_property("differing", int((got != ref).sum()))
    # the reference's own bar: edge-grazing points may differ
    bounded(record_property, "agreement", (got == ref).mean(), ">=", 0.999)


def test_plain_version_known_points_exact():
    got = pip.points_in_polys_ref(
        torch.as_tensor(KNOWN_PTS, dtype=torch.float32),
        torch.as_tensor(KNOWN_SQ, dtype=torch.float32),
    )[:, 0]
    assert got.tolist() == [True, False, False, True]


def test_plain_version_chunking_is_invisible():
    rng = np.random.default_rng(3)
    polys = torch.as_tensor(_square_and_triangle(), dtype=torch.float32)
    pts = torch.as_tensor(rng.uniform(0, 200, (777, 2)), dtype=torch.float32)
    whole = pip.points_in_polys_ref(pts, polys)
    pieces = pip.points_in_polys_ref(pts, polys, chunk_elems=5 * 16)
    assert torch.equal(whole, pieces)


def test_wrapper_sends_cpu_tensors_to_plain_version():
    rng = np.random.default_rng(1)
    polys = torch.as_tensor(_square_and_triangle(), dtype=torch.float32)
    pts = torch.as_tensor(rng.uniform(0, 200, (500, 2)), dtype=torch.float32)
    before = pip.pip_launches
    got = pip.points_in_polys(pts, polys)
    assert pip.pip_launches == before  # no kernel launch for CPU tensors
    assert torch.equal(got, pip.points_in_polys_ref(pts, polys))


@pytest.mark.parametrize("bad", ["dtype", "points_shape", "polys_shape",
                                 "mixed_devices", "other_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    pts = torch.zeros((4, 2), dtype=torch.float32)
    polys = torch.zeros((1, 4, 2), dtype=torch.float32)
    if bad == "dtype":
        pts = pts.double()
    elif bad == "points_shape":
        pts = torch.zeros((4, 3), dtype=torch.float32)
    elif bad == "polys_shape":
        polys = torch.zeros((4, 2), dtype=torch.float32)
    elif bad == "mixed_devices":
        polys = polys.to("meta")
    else:  # neither the CPU nor a CUDA device
        pts, polys = pts.to("meta"), polys.to("meta")
    with pytest.raises((TypeError, ValueError)):
        pip.points_in_polys(pts, polys)


def _parity_from_records(points, records, offsets):
    """Even-odd parity of (Q, 2) points against explicit edges: the rows
    (y1, y2, x1, dx) of polygon c are records[offsets[c]:offsets[c + 1]].
    The crossing is the plain version's, with dy = y2 - y1 used as it is."""
    x, y = points[:, 0, None], points[:, 1, None]
    out = torch.zeros((points.shape[0], len(offsets) - 1), dtype=torch.bool)
    for c in range(len(offsets) - 1):
        y1, y2, x1, dx = records[int(offsets[c]):int(offsets[c + 1])].T
        crosses = ((y1 > y) != (y2 > y)) & (x < dx * (y - y1) / (y2 - y1) + x1)
        out[:, c] = crosses.sum(dim=1) % 2 == 1
    return out


# vertices on a coarse grid: horizontal edges, repeated vertices and points
# level with a vertex are the rule, not the exception
_grid = st.integers(-3, 3).map(float)
_polygon = st.lists(st.tuples(_grid, _grid), min_size=3, max_size=9)


@settings(max_examples=150, deadline=None)
@given(polygon=_polygon, pad=st.integers(0, 3))
def test_dropping_level_edges_keeps_every_parity(polygon, pad):
    """The rule the kernel rests on: an edge with y1 == y2 straddles no
    point, so a polygon and its live edges give every point one parity."""
    verts = polygon + [polygon[-1]] * pad  # the caller's padding
    polys = torch.tensor([verts], dtype=torch.float32)
    ticks = torch.arange(-3.5, 4.0, 0.5)
    points = torch.cartesian_prod(ticks, ticks)
    records, offsets = pip.live_edges_ref(polys)
    assert (records[:, 0] != records[:, 1]).all()
    got = _parity_from_records(points, records, offsets)
    assert torch.equal(got, pip.points_in_polys_ref(points, polys))


def _live_edges_loop(polys):
    """numpy loop: the records and offsets live_edges_ref returns."""
    records, offsets = [], [0]
    for poly in polys:
        for k in range(len(poly)):
            (x1, y1), (x2, y2) = poly[k], poly[(k + 1) % len(poly)]
            if y2 != y1:
                records.append([y1, y2, x1, np.float32(x2) - np.float32(x1)])
        offsets.append(len(records))
    return (np.array(records, np.float32).reshape(-1, 4),
            np.array(offsets, np.int32))


@pytest.mark.parametrize("case", ["random", "padded", "all_dead",
                                  "minus_zero", "nan_vertex"])
def test_live_edges_ref_matches_numpy_loop(case):
    rng = np.random.default_rng(7)
    polys = rng.uniform(0, 100, (4, 12, 2)).astype(np.float32)
    if case == "padded":  # last vertex repeated, one polygon far away
        polys[:, 7:] = polys[:, 6:7]
        polys[3] = -1e7
    elif case == "all_dead":  # every polygon level or a single point
        polys[:, :, 1] = np.arange(4, dtype=np.float32)[:, None]
    elif case == "minus_zero":  # -0.0 == 0.0: the edge between them is dead
        polys[0, :4, 1] = [0.0, -0.0, 0.0, -0.0]
        polys[1, :, 1] = -0.0
    elif case == "nan_vertex":  # NaN != NaN: its edges count as live
        polys[2, 5, 1] = np.nan
    records, offsets = pip.live_edges_ref(torch.as_tensor(polys))
    want_records, want_offsets = _live_edges_loop(polys)
    assert offsets.dtype == torch.int32 and records.dtype == torch.float32
    np.testing.assert_array_equal(offsets.numpy(), want_offsets)
    np.testing.assert_array_equal(records.numpy(), want_records)
    if case == "all_dead":
        assert offsets.tolist() == [0] * 5 and records.shape == (0, 4)
    if case == "minus_zero":
        assert int(offsets[2] - offsets[1]) == 0


def test_live_edges_wrapper_sends_cpu_tensors_to_plain_version():
    rng = np.random.default_rng(2)
    polys = torch.as_tensor(rng.uniform(0, 9, (3, 6, 2)), dtype=torch.float32)
    before = pip.live_edges_launches
    got = pip.live_edges(polys)
    assert pip.live_edges_launches == before
    for g, w in zip(got, pip.live_edges_ref(polys)):
        assert torch.equal(g, w)
    with pytest.raises((TypeError, ValueError)):
        pip.live_edges(polys.double())
    with pytest.raises((TypeError, ValueError)):
        pip.live_edges(polys.to("meta"))


def _padded_like_classify(rng, c_pad=8, p_pad=64):
    """3 real contours padded the way classify_triangles pads them: the last
    vertex repeated to p_pad, the other polygons placed at -1e7."""
    polys = np.full((c_pad, p_pad, 2), -1e7)
    for c, (n, r) in enumerate([(40, 60.0), (23, 25.0), (9, 8.0)]):
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        rad = r * rng.uniform(0.8, 1.2, n)
        centre = rng.uniform(80, 120, 2)
        ring = centre + np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
        polys[c, :n] = ring
        polys[c, n:] = ring[-1]
    return polys


@pytest.mark.parametrize("reference", ["pallas_interpret", "jnp"])
def test_plain_version_matches_eitx_on_padded_buckets(reference, record_property):
    rng = np.random.default_rng(11)
    polys = _padded_like_classify(rng)
    pts = rng.uniform(0, 200, (2000, 2))
    pj, qj = jnp.asarray(pts, jnp.float32), jnp.asarray(polys, jnp.float32)
    if reference == "jnp":
        ref = np.asarray(_points_in_polys(pj, qj))
    else:
        ref = np.asarray(points_in_polys_pallas(pj, qj, interpret=True))
    pts_t = torch.as_tensor(pts, dtype=torch.float32)
    polys_t = torch.as_tensor(polys, dtype=torch.float32)
    got = pip.points_in_polys_ref(pts_t, polys_t)
    records, offsets = pip.live_edges_ref(polys_t)
    # what the kernel computes from the list: equal on every element
    assert torch.equal(_parity_from_records(pts_t, records, offsets), got)
    record_property("live_edges", int(offsets[-1]))
    assert int(offsets[-1]) <= 40 + 23 + 9 and offsets[3:].unique().numel() == 1
    assert got[:, :3].any() and not got[:, 3:].any()
    record_property("differing", int((got.numpy() != ref).sum()))
    bounded(record_property, "agreement", (got.numpy() == ref).mean(), ">=",
            0.999)


def _rings_round_the_origin(rng):
    """4 rings of 24 vertices round the origin whose vertices near the x
    axis are snapped to +0.0 and -0.0 in turn, and 600 points of which two
    in three lie on the axis, at y = -0.0 and +0.0 in turn."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, (4, 24)), axis=1)
    rad = rng.uniform(0.5, 2.0, (4, 24))
    polys = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    polys += rng.uniform(-0.3, 0.3, (4, 1, 2))
    near = np.abs(polys[:, :, 1]) < 0.4
    polys[:, :, 1] = np.where(
        near, np.where(np.arange(24) % 2 == 0, 0.0, -0.0), polys[:, :, 1])
    pts = rng.uniform(-2.5, 2.5, (600, 2))
    k = np.arange(600)
    pts[:, 1] = np.where(k % 3 == 2, pts[:, 1],
                         np.where(k % 2 == 0, -0.0, 0.0))
    return pts.astype(np.float32), polys.astype(np.float32)


@pytest.mark.parametrize("flipped", ["points", "polys", "both", "jnp"])
def test_plain_version_takes_signed_zeros_alike(flipped):
    """-0.0 == 0.0 in every comparison of the crossing test, so the sign of
    a zero y, a point's or a vertex's, changes no answer: the kernel may not
    tell them apart either."""
    pts, polys = _rings_round_the_origin(np.random.default_rng(13))
    assert np.signbit(pts[pts[:, 1] == 0, 1]).any()
    assert np.signbit(polys[polys[:, :, 1] == 0][:, 1]).any()
    want = pip.points_in_polys_ref(torch.as_tensor(pts), torch.as_tensor(polys))
    assert want[pts[:, 1] == 0].any() and not want[pts[:, 1] == 0].all()
    if flipped == "jnp":
        ref = np.asarray(_points_in_polys(jnp.asarray(pts), jnp.asarray(polys)))
        assert (want.numpy() == ref).mean() >= 0.999
        return
    pts2, polys2 = pts.copy(), polys.copy()
    if flipped in ("points", "both"):
        pts2[:, 1] = np.where(pts2[:, 1] == 0, -pts2[:, 1], pts2[:, 1])
    if flipped in ("polys", "both"):
        polys2[:, :, 1] = np.where(polys2[:, :, 1] == 0, -polys2[:, :, 1],
                                   polys2[:, :, 1])
    got = pip.points_in_polys_ref(torch.as_tensor(pts2),
                                  torch.as_tensor(polys2))
    assert torch.equal(got, want)
    records, offsets = pip.live_edges_ref(torch.as_tensor(polys2))
    assert torch.equal(
        _parity_from_records(torch.as_tensor(pts2), records, offsets), want)
