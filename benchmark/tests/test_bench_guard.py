"""The no-JAX rule on whole top-level names, the references' independence,
and what a run does without a card or without the program."""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

from benchmark.lib.guard import forbidden_modules
from benchmark.lib.manifest import HERE, ROOT


def test_forbidden_names_are_compared_whole():
    names = ["eitx_torch", "eitx_torch.fem.forward", "eitx", "eitx.fem",
             "jax", "jaxlib.xla_client", "flax.linen", "jax_foo", "flaxen",
             "numpy"]
    assert forbidden_modules(names) == ["eitx", "eitx.fem", "flax.linen",
                                        "jax", "jaxlib.xla_client"]


def _loaded_after(imports: str) -> set:
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n{imports}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    return set(r.stdout.split())


def test_the_harness_and_the_drivers_load_no_jax():
    top = _loaded_after(
        "import benchmark.run, benchmark.tools.readings\n"
        "from benchmark.lib.manifest import Cell, manifest\n"
        "b = manifest()\n"
        "[Cell(w['name'], b).driver() for w in b['workloads']]\n"
        "import eitx_torch.fem.forward, eitx_torch.train.trainer, "
        "eitx_torch.train.data")
    assert not top & {"jax", "jaxlib", "flax", "eitx"}


def test_the_references_import_nothing_of_the_program():
    top = _loaded_after(
        "import benchmark.reference.fem\n"
        "from benchmark.reference.yolo import data, trainer, prng")
    assert not top & {"eitx_torch", "eitx", "jax", "jaxlib", "flax"}
    pattern = re.compile(r"^\s*(from|import)\s+eitx", re.MULTILINE)
    for d, _, files in os.walk(os.path.join(HERE, "reference")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    assert not pattern.search(fh.read()), f


def test_no_card_no_result():
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "factory-thorax-lc7-b8", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "factory-thorax-lc7-b8", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""
