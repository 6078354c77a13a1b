"""Card-only tests of the port: the CUDA kernel against its plain
version, and the device path against the CPU path.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode); it
carries the ``cuda`` marker and skips without a card. The file imports
neither JAX nor eitx, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import collections
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")

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


@pytest.mark.parametrize("q,c,p", [(32768, 32, 512), (1000, 3, 700),
                                   (5, 1, 4)])
def test_pip_kernel_equals_plain_version(dev, q, c, p):
    from eitx_torch.mesh import pip

    rng = np.random.default_rng(q + c + p)
    pts = torch.as_tensor(rng.uniform(0, 512, (q, 2)), dtype=torch.float32,
                          device=dev)
    polys = torch.as_tensor(_random_polys(rng, c, p), dtype=torch.float32,
                            device=dev)
    before = pip.pip_launches
    got = pip.points_in_polys(pts, polys)
    torch.cuda.synchronize()
    assert pip.pip_launches == before + 1
    assert torch.equal(got, pip.points_in_polys_ref(pts, polys))


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
