"""The port stands alone: importing it pulls in neither JAX nor eitx."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "eitx_torch")

MODULES = [
    "eitx_torch",
    "eitx_torch.core",
    "eitx_torch.physio",
    "eitx_torch.fem",
    "eitx_torch.geometry",
    "eitx_torch.contours",
    "eitx_torch.mesh",
    "eitx_torch.image",
    "eitx_torch.masks",
    "eitx_torch.models.yolo",
    "eitx_torch.io",
    "eitx_torch.pipeline",
]


def test_import_leaves_jax_and_eitx_out():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'flax' or m == 'eitx' or "
        "m.startswith('eitx.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|eitx)\b(?!_)|from\s+(jax|flax|eitx)\b(?!_))",
    re.MULTILINE,
)


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize(
    "path", sorted(os.path.relpath(p, ROOT) for p in _sources()))
def test_source_has_no_jax_or_eitx_import(path):
    with open(os.path.join(ROOT, path)) as fh:
        text = fh.read()
    assert not _FORBIDDEN.search(text), path


def test_default_device_is_cuda_and_never_falls_back():
    from eitx_torch.core.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"
