"""Each cell driven end to end at a size a test run holds, on the CPU, with
the harness's look for a card skipped: the sound program comes out
correct, and each fault the cell can have, planted in the timed path,
comes out not correct. The control (TF32) needs the card."""

from __future__ import annotations

import pytest
import torch

from benchmark.lib.manifest import Cell, manifest
from benchmark.run import run_cell

SEED = 2147483659


def small(name: str) -> Cell:
    cell = Cell(name, manifest())
    if cell.config["kind"] == "fem":
        cell.traffic.update(pool=2, batch=min(2, cell.traffic["batch"]))
    else:
        cell.config["train"].update(imgsz=64)
        cell.config.update(batch=4, mask_res=32)
        cell.traffic.update(store=8)
    cell.spec["trace_steps"] = 1
    return cell


CELLS = [w["name"] for w in manifest()["workloads"]]
FAULTS = [(c, f) for c in CELLS for f in Cell(c, manifest()).spec["faults"]]


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_is_correct(name):
    r = run_cell(small(name), SEED, 0.3, False, torch.device("cpu"))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_planted_fault_is_not_correct(name, fault):
    r = run_cell(small(name), SEED, 0.3, False, torch.device("cpu"),
                 variant=fault)
    assert not r["correct"], r["checks"]


def test_a_traced_run_reports_the_layers_it_reads():
    r = run_cell(small("factory-thorax-lc7-b8"), SEED, 0.3, True,
                 torch.device("cpu"))
    assert r["correct"]
    assert {"fem.prep_ms", "fem.assembly_ms", "fem.setup_ms"} <= set(
        r["metrics"])
    assert "window_s" in r["device"] and "breakdown" in r


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_is_not_correct(name, cuda_device):
    r = run_cell(Cell(name, manifest()), SEED, 2.0, False, cuda_device,
                 variant="tf32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not r["correct"], r["checks"]
