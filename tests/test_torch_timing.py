"""The port's spans and counters (``eitx_torch/core/timing.py``): with no
profiler recording they enter nothing and record nothing; under a CPU
profiler they are ranges of the trace, nested as they run, and the table
counts their calls and seconds. The FEM call's stages and the train
step's phases are each recorded once a subject or a step, and leave the
voltages, the loss, the parameters and the EMA bit-equal."""

import collections

import numpy as np
import pytest
import torch

from eitx_torch.core import timing
from eitx_torch.core.config import SimulationConfig
from eitx_torch.core.timing import Timer
from eitx_torch.fem import (
    simulate_eit_monitoring,
    simulate_eit_monitoring_subjects,
)
from eitx_torch.train import TrainConfig, Trainer, synthetic_ct_batch
from eitx_torch.train.data import device_batches
from eitx_torch.train.trainer import EMA
from meshfix import disk_mesh_with_classes

CPU = "cpu"
FEM_CFG = SimulationConfig(n_points=3, pad_nodes_to=512, pad_elems_to=1024)
TRAIN_CFG = dict(imgsz=64, variant="n", max_instances=4, total_steps=10,
                 warmup_steps=0, lr=1e-4, assigner="tal")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The network's CPU steps on one thread: the parallel test workers
    share the cores."""
    # never set back above 1: a batched float32 linalg.solve (oneMKL)
    # later in the same worker can then hang
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def empty_table():
    timing.clear()
    yield
    timing.clear()


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _ranges(prof):
    return collections.Counter(e.name for e in prof.events()
                               if e.name.startswith("eitx."))


def test_without_a_profiler_nothing_is_entered_or_recorded(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    timer = Timer()
    with timing.span("eitx.a"), timing.span("eitx.b", CPU):
        timing.count("eitx.c", 5)
        with timer.span("segmentation"):
            pass
    assert timing.recorded() == ({}, {})
    assert set(timer.as_dict()) == {"segmentation"}


def test_under_a_profiler_ranges_nest_and_the_table_counts():
    with _profiler() as prof:
        for _ in range(3):
            with timing.span("eitx.outer"):
                with timing.span("eitx.inner", CPU):
                    torch.ones(8).sum()
        timing.count("eitx.items", 2)
        timing.count("eitx.items", 5)
    spans, counters = timing.recorded()
    assert _ranges(prof) == {"eitx.outer": 3, "eitx.inner": 3}
    inner = [e for e in prof.events() if e.name == "eitx.inner"]
    assert all(e.cpu_parent.name == "eitx.outer" for e in inner)
    assert {n: s["calls"] for n, s in spans.items()} == {
        "eitx.outer": 3, "eitx.inner": 3}
    assert spans["eitx.outer"]["host_s"] >= spans["eitx.inner"]["host_s"] > 0
    # no CUDA events on the CPU: no device time
    assert spans["eitx.inner"]["device_s"] is None
    assert counters == {"eitx.items": 7}
    timing.clear()
    assert timing.recorded() == ({}, {})


def test_a_span_lets_an_exception_through_and_closes_its_range():
    with _profiler() as prof:
        with pytest.raises(ValueError):
            with timing.span("eitx.raises"):
                raise ValueError("inside")
        with timing.span("eitx.after"):
            pass
    assert _ranges(prof) == {"eitx.raises": 1, "eitx.after": 1}
    assert timing.recorded()[0]["eitx.raises"]["calls"] == 1


def test_timer_spans_are_the_pipeline_ranges():
    timer = Timer()
    with _profiler() as prof:
        with timer.span("mesh"):
            with timer.span("simulation"):
                pass
        with timer.span("mesh"):
            pass
    assert set(timer.as_dict()) == {"mesh", "simulation"}
    assert _ranges(prof) == {"eitx.pipeline.mesh": 2,
                             "eitx.pipeline.simulation": 1}
    assert timing.recorded()[0]["eitx.pipeline.mesh"]["calls"] == 2


def _mesh_data(nb, rings):
    nodes, tris, cls = disk_mesh_with_classes(nb, rings)
    return {"NODES": nodes * 100.0, "TRIANGLES": tris, "CLASS": cls}


FEM_STAGES = ("schedule", "mesh_info", "electrodes", "assembly",
              "setup.select", "setup.factor", "solve", "readback")


@pytest.mark.parametrize("call", ["subjects", "single"])
def test_fem_stages_are_recorded_and_leave_the_voltages(call):
    meshes = [_mesh_data(40, 6), _mesh_data(48, 6), _mesh_data(40, 5)]
    if call == "single":
        meshes = meshes[:1]

    def run():
        if call == "single":
            return [simulate_eit_monitoring(meshes[0], FEM_CFG,
                                            device=CPU)[0]]
        return [v for v, _ in simulate_eit_monitoring_subjects(
            meshes, FEM_CFG, device=CPU)]

    plain = run()
    assert timing.recorded() == ({}, {})
    with _profiler() as prof:
        traced = run()
    assert all(np.array_equal(a, b) for a, b in zip(plain, traced))
    spans, counters = timing.recorded()
    n = len(meshes)
    # one schedule, setup and solve a call (the subjects share one bucket);
    # the mesh dict and its compaction are two spans a subject
    want = {"schedule": 1, "mesh_info": 2 * n, "electrodes": n,
            "assembly": n, "setup.select": 1, "setup.factor": 1,
            "solve": 1, "readback": n}
    assert {s: spans[f"eitx.fem.{s}"]["calls"] for s in FEM_STAGES} == want
    assert _ranges(prof) == {f"eitx.fem.{s}": c for s, c in want.items()}
    assert counters.get("eitx.fem.subjects") == n
    # nothing goes to a card here
    assert counters.get("eitx.fem.upload_bytes", 0) == 0


def _small_trainer():
    tr = Trainer(TrainConfig(**TRAIN_CFG), device=CPU)
    return tr, EMA(tr.local_params(), 0.99)


TRAIN_PHASES = ("step", "forward", "loss", "assign", "backward", "update",
                "ema")


def test_train_phases_are_recorded_and_leave_the_step():
    batch = synthetic_ct_batch(2, 64, 4, seed=3)
    runs = []
    for traced in (False, True):
        tr, ema = _small_trainer()
        if traced:
            with _profiler() as prof:
                loss = tr.train_step(batch, device_metrics=True)["loss"]
                ema.update(tr.local_params())
        else:
            loss = tr.train_step(batch, device_metrics=True)["loss"]
            ema.update(tr.local_params())
            assert timing.recorded() == ({}, {})
        runs.append((loss, tr.local_params(), ema.params))
    (l0, p0, e0), (l1, p1, e1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert all(torch.equal(e0[n], e1[n]) for n in e0)
    spans, _ = timing.recorded()
    assert {p: spans[f"eitx.train.{p}"]["calls"] for p in TRAIN_PHASES} == \
        dict.fromkeys(TRAIN_PHASES, 1)
    names = _ranges(prof)
    assert names == {f"eitx.train.{p}": 1 for p in TRAIN_PHASES}
    parent = {e.name: e.cpu_parent.name if e.cpu_parent else None
              for e in prof.events() if e.name.startswith("eitx.")}
    assert parent["eitx.train.assign"] == "eitx.train.loss"
    assert parent["eitx.train.forward"] == "eitx.train.step"
    assert parent["eitx.train.backward"] == "eitx.train.step"
    assert parent["eitx.train.ema"] is None


def test_each_drawn_batch_is_one_span_and_the_same_batch():
    store = synthetic_ct_batch(6, 64, 4, seed=7)

    def draw(n):
        stream = device_batches(store, 2, seed=5, device=CPU)
        return [next(stream) for _ in range(n)]

    plain = draw(3)
    with _profiler() as prof:
        traced = draw(3)
    for a, b in zip(plain, traced):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert timing.recorded()[0]["eitx.train.batch"]["calls"] == 3
    assert _ranges(prof) == {"eitx.train.batch": 3}


# the table a traced run could leave, and what each of the benchmark's
# readers of the program's spans makes of it (ms a subject or a step)
TABLE = ({
    "eitx.fem.electrodes": {"calls": 10, "host_s": 0.3, "device_s": None},
    "eitx.fem.setup.select": {"calls": 2, "host_s": 0.2, "device_s": None},
    "eitx.fem.setup.factor": {"calls": 2, "host_s": 0.1, "device_s": 0.4},
    "eitx.fem.readback": {"calls": 10, "host_s": 0.05, "device_s": None},
    "eitx.train.batch": {"calls": 4, "host_s": 0.04, "device_s": None},
    "eitx.train.step": {"calls": 4, "host_s": 1.0, "device_s": 1.1},
    "eitx.train.forward": {"calls": 4, "host_s": 0.2, "device_s": 0.3},
    "eitx.train.loss": {"calls": 4, "host_s": 0.3, "device_s": 0.2},
    "eitx.train.assign": {"calls": 4, "host_s": 0.1, "device_s": 0.05},
    "eitx.train.backward": {"calls": 4, "host_s": 0.2, "device_s": 0.5},
    "eitx.train.update": {"calls": 4, "host_s": 0.1, "device_s": 0.03},
    "eitx.train.ema": {"calls": 4, "host_s": 0.02, "device_s": 0.01},
}, {"eitx.fem.subjects": 10, "eitx.fem.upload_bytes": 1e8})
READS = {"fem.electrodes_ms": 30.0, "fem.setup_host_ms": 20.0,
         "fem.factor_ms": 40.0, "fem.readback_ms": 5.0,
         "fem.upload_mb": 10.0, "train.host_ms": 265.0,
         "train.forward_ms": 75.0, "train.loss_ms": 50.0,
         "train.assign_ms": 12.5, "train.backward_ms": 125.0,
         "train.update_ms": 10.0}


@pytest.mark.parametrize("metric", sorted(READS))
def test_a_benchmark_reader_reads_the_program_table(metric, monkeypatch):
    from benchmark.lib.manifest import load_module

    read = load_module("metrics", metric).read
    ctx = {"steps": 4, "layer": {"subjects": 10}}
    monkeypatch.setattr(timing, "recorded", lambda: TABLE)
    assert read(ctx) == pytest.approx(READS[metric], rel=1e-12)
    assert read(dict(ctx, steps=0)) is None
    # a program without the table, as before it had spans, reads nothing
    monkeypatch.delattr(timing, "recorded")
    assert read(ctx) is None
