"""The port stands alone: importing it pulls in neither JAX nor eitx."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "eitx_torch")
EXAMPLES = os.path.join(ROOT, "examples", "torch")
BENCH = os.path.join(ROOT, "bench_torch.py")
# what runs on the card's machine, which has no JAX: the smoke run and the
# card tools of tests/
CARD_SCRIPTS = [os.path.join(ROOT, "chip_smoke.py")] + [
    os.path.join(ROOT, "tests", f) for f in (
        "torch_train_repro.py", "torch_train_turns.py", "torch_seg_span.py",
        "torch_parallel_cards.py", "torch_card_vs_cpu.py",
        "torch_prng_check.py")]

MODULES = [
    "eitx_torch",
    "eitx_torch.core",
    "eitx_torch.core.prng",
    "eitx_torch.physio",
    "eitx_torch.fem",
    "eitx_torch.geometry",
    "eitx_torch.contours",
    "eitx_torch.mesh",
    "eitx_torch.image",
    "eitx_torch.masks",
    "eitx_torch.models.yolo",
    "eitx_torch.io",
    "eitx_torch.select",
    "eitx_torch.pipeline",
    "eitx_torch.serve",
    "eitx_torch.serve.client",
    "eitx_torch.eval",
    "eitx_torch.core.toml_config",
    "eitx_torch.core.log",
    "eitx_torch.train",
    "eitx_torch.train.phantoms",
    "eitx_torch.train.checkpoint",
    "eitx_torch.scripts.pseudo_label",
    "eitx_torch.scripts.train_tissue",
    "eitx_torch.scripts.train_ribs",
    "eitx_torch.models.yolo.convert",
    "eitx_torch.models.yolo.init",
    "eitx_torch.models.yolo.ptread",
    "eitx_torch.parallel",
    "eitx_torch.parallel.dryrun",
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
    for top in (PKG, EXAMPLES):
        for d, _, files in os.walk(top):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(d, f)
    yield BENCH
    yield from CARD_SCRIPTS


@pytest.mark.parametrize(
    "path", sorted(os.path.relpath(p, ROOT) for p in _sources()))
def test_source_has_no_jax_or_eitx_import(path):
    with open(os.path.join(ROOT, path)) as fh:
        text = fh.read()
    assert not _FORBIDDEN.search(text), path


def test_examples_leave_jax_and_eitx_out():
    """Loading every example of examples/torch/ pulls in neither."""
    names = sorted(f[:-3] for f in os.listdir(EXAMPLES) if f.endswith(".py"))
    assert len(names) == 6
    code = (
        "import importlib.util, os, sys\n"
        f"for name in {names!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        f"        name, os.path.join({EXAMPLES!r}, name + '.py'))\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'eitx'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_bench_leaves_jax_and_eitx_out():
    """Importing bench_torch.py, the port's benchmark, pulls in neither."""
    code = (
        "import sys\n"
        "import bench_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'eitx'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_is_cuda_and_never_falls_back():
    from eitx_torch.core.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_exports_match_eitx():
    """The names eitx's packages export where the port has them: the
    pipeline's batch factory, the timing module's device trace, the
    training package, the parallel package (eitx's five names and the
    group solve)."""
    import eitx_torch.parallel as parallel
    import eitx_torch.pipeline as pipeline
    import eitx_torch.train as train
    from eitx_torch.core import timing

    for name in ("Pipeline", "build_answer", "generate_batch",
                 "load_manifest"):
        assert name in pipeline.__all__ and hasattr(pipeline, name), name
    for name in ("TrainConfig", "Trainer", "TrainState", "device_batches",
                 "synthetic_ct_batch"):
        assert name in train.__all__ and hasattr(train, name), name
    assert callable(timing.device_trace)
    for name in ("make_device_mesh", "shard_batch", "shard_params_fsdp",
                 "sharded_eit_monitoring", "sharded_segment_labels",
                 "sharded_group_solve"):
        assert name in parallel.__all__ and hasattr(parallel, name), name


def test_device_trace_is_a_noop_without_logdir(tmp_path):
    from eitx_torch.core.timing import device_trace

    with device_trace(None):
        x = torch.ones(3).sum()
    assert float(x) == 3.0
    with device_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert os.listdir(tmp_path / "trace")
