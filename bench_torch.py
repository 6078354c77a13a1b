"""Benchmark of the PyTorch/CUDA port on one NVIDIA GPU: bench.py's
sections, run on eitx_torch.

    python3 bench_torch.py [--section NAME ...] [--seed N] [--device cuda]

Sections, in the order they run (each a function of bench.py's name and
default arguments, plus ``device`` and ``seed``):

  bench_eit                   the lc-7 thorax of build_thorax_mesh, 1200
                              breathing frames: LowRankSpectralSolver.build
                              + solve, setup included; the solve alone at
                              50 x the frames; the setup alone
  bench_eit_oracle            the float64 scipy oracle per frame on the
                              host, credited at max(8, cpu_count) cores:
                              the baseline
  bench_eit_batch             8 thorax subjects x 1200 frames through
                              build_batch + lowrank_solve_batch, and the
                              whole tail (simulate_eit_monitoring_subjects)
  bench_segmentation          the untrained YOLOv11-s TissueSegmenter of
                              the seed (eitx's initial parameters: at
                              seed 0 bench.py's network) in bfloat16, 512
                              uint8 images of 512^2: end to end
                              (segment_labels), on the device alone
                              (_segment_labels_device on a resident
                              input), and the host-to-device link
  bench_serving_segmentation  the checkpoint find_checkpoint("tissue",
                              512) resolves, same batch, device alone
  bench_dataset_factory       4 + 1 phantom slices of 512^2 through
                              Pipeline.run_jpg_png at the serving
                              PipelineConfig with save_dataset: a cold
                              pass, then timed warm passes
  bench_greit                 GREIT: 12,000 frames through the trained
                              matrix (fem/greit.py _apply), and the
                              GreitImager build, first and warm

What changes from bench.py, and why:
  - Each section prints one JSON line as it ends (flushed), so a run cut
    by a time limit still leaves every finished section behind;
    bench.py printed one line at its very end. A line holds the section's
    name, its metrics under bench.py's key names, and for each timing its
    sample count (``_n``), its ``_min`` and ``_max`` and, as the headline,
    its median; bench.py's best repeat stays under ``_best``. Every
    section runs once more under torch.profiler after its timed repeats
    (which run with profiling off) and prints the device's busy and idle
    share and its five longest operations (on the card only; the oracle
    runs no device work and is not profiled). A last line sums the run:
    ``bench_wall_s``, the card's name and power limit, the checks.
  - ``--section`` (repeatable) runs only the sections it names; ``--seed``
    makes every input: the random weights, the images, the subjects'
    seeds (the jittered thoraxes' seeds and the factory's phantom seeds
    9100 + s are offset by it) and the GREIT frames. The single-subject
    thorax and the breathing schedule are fixed, as in bench.py.
  - Nothing is best effort: a section that raises ends the run with a
    non-zero exit, nothing falls back to the CPU or to a plain version,
    and a missing serving checkpoint is an error.
  - Each section checks its output, prints the check beside its numbers,
    and a failed check makes the run exit non-zero (after the remaining
    sections): bench_eit's frames 0 and T/2 against the float64 oracle
    (max rel < 2e-2, mean rel < 2e-3: tests/test_realfixture.py:136-137);
    bench_eit_batch's subject 0 against its own single-subject solve (rtol
    2e-4, atol 1e-7: tests/test_spectral.py:81); both segmentation
    sections' end-to-end labels equal to the device-only call's on every
    pixel, and the untrained segmenter's parameters equal to the JAX
    package's for seed 0 (tests/data/torch_prng_fixture.npz: per-leaf
    sums, first elements, the bfloat16 rounding served); every factory subject ``success`` and each subject's ``.dat``
    of every warm pass byte-equal to its cold-pass file; GREIT's images
    against ``R.double() @ dv.double()`` on the host within 1e-5 of scale.
  - ``mfu``: FLOPs over the time over the card's peak. bench.py read
    XLA's cost_analysis and a TPU peak. Here the segmenter's FLOPs are
    torch.utils.flop_counter.FlopCounterMode's count over its network
    calls (convolutions and products), the FEM's a count written from the
    shapes of _lowrank_core and _lowrank_solve (``lowrank_setup_flops``,
    ``lowrank_solve_flops``); the peaks come from the card's name
    (``PEAKS``), and an unlisted card gets ``null`` shares with its name
    printed. A step that mixes both (``eit_forward_mfu``, ``pipeline_mfu``)
    is sum_k flops_k / peak_k / wall. The raw TFLOP/s stand beside every
    share, so each can be derived again under another peak.
  - The device-only segmentation call takes the resident batch in the
    end-to-end path's chunks (16 images): the card picks its convolution
    algorithms by batch size, so labels of a 512-image call need not
    equal those of 16-image calls, and the check needs the same calls.
  - bench_eit_batch and bench_dataset_factory take ``repeats`` (bench.py
    timed them once), so they too report a median.
  - Repeats are bench.py's; the whole run fits 10 minutes on one H100
    with no section's size or repeats lowered.
  - The factory writes its ``.dat`` files into a temporary directory,
    removed when the section ends.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from eitx_torch.core.config import ClassMap, PipelineConfig, SimulationConfig
from eitx_torch.core.device import resolve_device
from eitx_torch.core.timing import Timer
from eitx_torch.core.weights import find_checkpoint
from eitx_torch.fem import spectral
from eitx_torch.fem.assembly import ClassStiffness
from eitx_torch.fem.electrodes import place_electrodes_equal_spacing
from eitx_torch.fem.forward import (
    build_sigma_frames,
    compact_mesh_nodes,
    prepare_mesh_info,
    simulate_eit_monitoring_subjects,
)
from eitx_torch.fem.greit import GreitImager, _apply
from eitx_torch.fem.inverse import monitoring_linearization
from eitx_torch.fem.oracle import forward_solve_oracle, monitoring_oracle
from eitx_torch.fem.protocol import create_protocol
from eitx_torch.fem.spectral import LowRankSpectralSolver, lowrank_solve_batch
from eitx_torch.models.yolo.infer import TissueSegmenter
from eitx_torch.models.yolo.init import flax_init_state
from eitx_torch.models.yolo.model import yolov11_spec
from eitx_torch.physio.materials import (
    generate_material_tables,
    tissue_conductivities,
)
from eitx_torch.physio.spirometry import conductivity_schedule
from eitx_torch.pipeline.modes import Pipeline
from eitx_torch.scripts.profile_setup import thorax_mesh as build_thorax_mesh
from eitx_torch.train.phantoms import phantom_batch

# tests/torch_prng_check.py reads tests/data/torch_prng_fixture.npz, the JAX
# package's initial parameters that bench_segmentation's check holds to
_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
if _TESTS not in sys.path:
    sys.path.append(_TESTS)
import torch_prng_check  # noqa: E402

SECTIONS = (
    "bench_eit",
    "bench_eit_oracle",
    "bench_eit_batch",
    "bench_segmentation",
    "bench_serving_segmentation",
    "bench_dataset_factory",
    "bench_greit",
)
# sections that take the lc-7 thorax as their first argument
MESH_SECTIONS = ("bench_eit", "bench_eit_oracle", "bench_greit")

# Dense peak FLOP/s by card name: (bfloat16 on the tensor cores, float32
# without TF32, as the FEM path runs), NVIDIA's H100 datasheet.
PEAKS = {
    "H100 80GB HBM3": (989.4e12, 66.9e12),  # SXM5
    "H100 PCIe": (756.5e12, 51.2e12),
}

# the float64 oracle's bounds on a float32 solve (test_realfixture.py:136-137)
ORACLE_MAX_REL = 2e-2
ORACLE_MEAN_REL = 2e-3
# batched vs single-subject solve (tests/test_spectral.py:81)
BATCH_RTOL, BATCH_ATOL = 2e-4, 1e-7
GREIT_OF_SCALE = 1e-5
GREIT_PROFILE_APPLIES = 100
# segment_labels' chunk, passed to both segmentation paths
SEG_CHUNK = 16
TOP_OPS = 5


# ---------------------------------------------------------------------------
# Measuring
# ---------------------------------------------------------------------------


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_runs(fn, repeats: int, dev: torch.device) -> list:
    """Seconds of ``repeats`` calls of ``fn``, each ended by a device
    synchronisation."""
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append(time.perf_counter() - t0)
    return out


def _stats(key: str, values, best) -> dict:
    """The median of ``values`` under ``key``, the ``best`` of them, the
    min, the max and the sample count."""
    return {key: float(np.median(values)), f"{key}_best": best(values),
            f"{key}_min": min(values), f"{key}_max": max(values),
            f"{key}_n": len(values)}


def rate_stats(key: str, work: float, seconds) -> dict:
    """``work`` per second of each run; the best is the fastest."""
    return _stats(key, [work / s for s in seconds], max)


def seconds_stats(key: str, seconds) -> dict:
    """Seconds of each run; the best is the shortest."""
    return _stats(key, list(seconds), min)


def _busy_ms(events) -> float:
    """Union of the device's kernel and copy intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy / 1e3


def profiled(fn, dev: torch.device):
    """One more run of ``fn`` under torch.profiler: its wall time, the
    device's busy time, busy and idle shares and the five device
    operations with the most time. None off the card."""
    if dev.type != "cuda":
        return None
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy = _busy_ms(events)
    if busy <= 0:
        raise RuntimeError(
            f"the profiled run shows no device time ({len(events)} events)")
    ops = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ops[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
            ops[e.name][1] += 1
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                busy_share=busy / wall_ms, idle_share=1.0 - busy / wall_ms,
                top_device_ops=[{"name": n[:80], "ms": ms, "count": k}
                                for n, (ms, k) in top])


# ---------------------------------------------------------------------------
# FLOPs and peaks
# ---------------------------------------------------------------------------


def lowrank_setup_flops(b: int, n: int, r: int, n_exc: int) -> float:
    """FLOPs of ``_lowrank_core`` on a stack of ``b`` subjects: padded
    node count ``n``, rank bucket ``r``, ``n_exc`` excitations.

    Convention (the work of the algorithm, whatever implements it): a
    Cholesky of an m x m matrix m^3/3; a triangular solve of an m x m
    factor against k right-hand sides m^2 k; a product (a x k)(k x c)
    2akc; a symmetric eigendecomposition with its vectors 9m^3;
    elementwise work, gathers and K_base's class sum are not counted.
    Per subject: chol(K_base) n^3/3; L \\ [S, B] n^2 (r + n_exc); G = P^T P
    2nr^2; chol(G) r^3/3; C^T (Kl_s C) 4r^3; eigh 9r^3; C^-T Z r^3;
    Q = P Y 2nr^2; L^-T [Q, C0] n^2 (r + n_exc); Q^T C0 2nr n_exc."""
    per = (n ** 3 / 3 + 2 * n ** 2 * (r + n_exc) + 4 * n * r ** 2
           + r ** 3 / 3 + 4 * r ** 3 + 9 * r ** 3 + r ** 3
           + 2 * n * r * n_exc)
    return float(b * per)


def lowrank_solve_flops(b: int, t: int, r: int, n_meas: int) -> float:
    """FLOPs of ``_lowrank_solve``: the (t, r) x (r, n_meas) product of
    each of ``b`` subjects, 2 t r n_meas (the rest is elementwise)."""
    return float(b * 2 * t * r * n_meas)


@contextlib.contextmanager
def counted_flops(segmenters=()):
    """While open, every low-rank setup and solve adds its count to
    ``counts["setup"]`` / ``counts["solve"]`` (float32 work), and every
    network call of ``segmenters`` adds FlopCounterMode's count to
    ``counts["network"]`` (bfloat16 work: every segmenter of the bench
    runs in bfloat16); yields ``counts``."""
    counts = {"setup": 0.0, "solve": 0.0, "network": 0.0}
    core, solve = spectral._lowrank_core, spectral._lowrank_solve

    def core_counted(K_base, Kl, idx, mask, S, Brhs, readout_rows):
        counts["setup"] += lowrank_setup_flops(
            K_base.shape[0], K_base.shape[-1], idx.shape[-1], Brhs.shape[-1])
        return core(K_base, Kl, idx, mask, S, Brhs, readout_rows)

    def solve_counted(s2, u0, yq, zq, alphas, alpha0s, meas_mat):
        counts["solve"] += lowrank_solve_flops(
            s2.shape[0], alphas.shape[0], s2.shape[-1],
            meas_mat.shape[0] * meas_mat.shape[1])
        return solve(s2, u0, yq, zq, alphas, alpha0s, meas_mat)

    def network_counted(run):
        def counted(*args, **kwargs):
            with FlopCounterMode(display=False) as counter:
                out = run(*args, **kwargs)
            counts["network"] += float(counter.get_total_flops())
            return out
        return counted

    spectral._lowrank_core, spectral._lowrank_solve = core_counted, solve_counted
    for seg in segmenters:
        seg._segment_labels_device = network_counted(seg._segment_labels_device)
    try:
        yield counts
    finally:
        spectral._lowrank_core, spectral._lowrank_solve = core, solve
        for seg in segmenters:
            del seg._segment_labels_device


def card_peaks(dev: torch.device):
    """(bf16, f32) dense peak FLOP/s of the card, or None: off the card,
    or for a card ``PEAKS`` does not list."""
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    for tag, peaks in PEAKS.items():
        if tag in name:
            return peaks
    print(f"bench_torch: no peak FLOP/s listed for {name!r}: mfu keys null",
          file=sys.stderr, flush=True)
    return None


def tflops(flops: float, seconds: float) -> float:
    return flops / seconds / 1e12


def mfu(peaks, seconds: float, bf16: float = 0.0, f32: float = 0.0):
    """sum_k flops_k / peak_k / seconds; None without peaks."""
    if peaks is None:
        return None
    return (bf16 / peaks[0] + f32 / peaks[1]) / seconds


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def oracle_rel(v: np.ndarray, ref: np.ndarray) -> dict:
    rel = np.abs(v - ref) / (np.abs(ref) + 1e-9)
    return {"max_rel": float(rel.max()), "mean_rel": float(rel.mean())}


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------


def breathing_schedule(frames: int, device):
    """bench.py's schedule: 12 breaths over ``frames`` at 50 kHz. Returns
    the (T, C) conductivities, the lung's class id, its (T,) float32
    column on ``device``, its mean (the pencil's alpha0) and the adjacent
    16-electrode protocol."""
    classes = ClassMap()
    mats = generate_material_tables()
    _, condspir = conductivity_schedule(12, frames, 5e4, mats)
    base = tissue_conductivities(mats, 5e4, classes.id_to_name())
    sigma = build_sigma_frames(condspir, base, classes)
    lung = classes.name_to_id()["lung"]
    alphas = torch.as_tensor(sigma[:, lung], dtype=torch.float32,
                             device=device)
    return (sigma, lung, alphas, float(np.mean(sigma[:, lung])),
            create_protocol(16, 1, 1, "std"))


def _electrodes(info) -> np.ndarray:
    return place_electrodes_equal_spacing(info.node, info.element, 16,
                                          starting_angle=np.pi)


@dataclasses.dataclass
class EitSystem:
    """bench.py's single-subject job on one mesh."""

    info: object
    sigma: np.ndarray  # (T, C) float64
    lung: int
    el: np.ndarray
    proto: object
    cs: ClassStiffness
    alphas: torch.Tensor  # (T,) float32 on the device
    alpha0: float

    def build(self) -> LowRankSpectralSolver:
        return LowRankSpectralSolver.build(
            self.cs, self.sigma[0], self.lung, self.el, self.proto.ex_mat,
            self.proto.meas_mat, self.alpha0)

    def full_job(self) -> torch.Tensor:
        """Setup + solve of every frame: (T, n_exc, n_meas)."""
        return self.build().solve(self.alphas)


def eit_system(mesh, frames: int, device="cuda") -> EitSystem:
    """bench.py:96-118 on the port: the breathing schedule, equally
    spaced electrodes from pi, and the class stiffness padded to the
    subject's own fine bucket (256 nodes, 2048 elements)."""
    dev = resolve_device(device)
    info = compact_mesh_nodes(prepare_mesh_info(mesh, ClassMap()))
    sigma, lung, alphas, alpha0, proto = breathing_schedule(frames, dev)
    cs = ClassStiffness.build(info.node, info.element, info.cond,
                              n_classes=5, pad_nodes_to=256,
                              pad_elems_to=2048, device=dev)
    return EitSystem(info=info, sigma=sigma, lung=lung, el=_electrodes(info),
                     proto=proto, cs=cs, alphas=alphas, alpha0=alpha0)


def bench_eit(mesh, frames=1200, repeats=3, device="cuda", seed=0) -> dict:
    """Breathing frames per second of one subject, setup included; the
    solve alone at 50 x ``frames``; the setup alone. ``seed`` is unused:
    the thorax and the schedule are fixed, as in bench.py."""
    dev = resolve_device(device)
    sys_ = eit_system(mesh, frames, dev)
    v = sys_.full_job()  # warm-up
    _sync(dev)
    times = timed_runs(sys_.full_job, repeats, dev)

    solver = sys_.build()
    big = sys_.alphas.repeat(50)
    solver.solve(big)  # warm-up
    solve_times = timed_runs(lambda: solver.solve(big), 5, dev)
    setup_times = timed_runs(sys_.build, 3, dev)

    with counted_flops() as full:
        sys_.full_job()
    with counted_flops() as big_count:
        solver.solve(big)
    peaks = card_peaks(dev)
    t_full, t_setup = float(np.median(times)), float(np.median(setup_times))
    t_solve = float(np.median(solve_times))
    fem_flops = full["setup"] + full["solve"]

    picked = [0, frames // 2]
    got = v[picked].cpu().numpy()
    ref = monitoring_oracle(sys_.info.node, sys_.info.element,
                            sys_.sigma[picked][:, sys_.info.cond], sys_.el,
                            sys_.proto.ex_mat, sys_.proto.meas_mat)
    err = oracle_rel(got, ref)
    ok = (got.shape == ref.shape and bool(np.isfinite(got).all())
          and err["max_rel"] < ORACLE_MAX_REL
          and err["mean_rel"] < ORACLE_MEAN_REL)
    return {
        **rate_stats("eit_forward_frames_per_sec", frames, times),
        **rate_stats("spectral_solve_only_frames_per_sec", big.shape[0],
                     solve_times),
        **seconds_stats("eit_setup_seconds", setup_times),
        "mesh_nodes": int(sys_.info.node.shape[0]),
        "padded_nodes": int(sys_.cs.k_class.shape[-1]),
        "workload_frames": frames,
        "solve_only_frames": int(big.shape[0]),
        "eit_setup_flops": full["setup"],
        "eit_solve_flops": big_count["solve"],
        "eit_forward_flops": fem_flops,
        "eit_setup_tflops": tflops(full["setup"], t_setup),
        "eit_solve_tflops": tflops(big_count["solve"], t_solve),
        "eit_forward_tflops": tflops(fem_flops, t_full),
        "eit_setup_mfu": mfu(peaks, t_setup, f32=full["setup"]),
        "eit_solve_mfu": mfu(peaks, t_solve, f32=big_count["solve"]),
        "eit_forward_mfu": mfu(peaks, t_full, f32=fem_flops),
        "oracle_frames": picked,
        "oracle_max_rel": err["max_rel"],
        "oracle_mean_rel": err["mean_rel"],
        "profile": profiled(sys_.full_job, dev),
        "check": ok,
    }


def bench_eit_oracle(mesh, frames=9, device="cuda", seed=0) -> dict:
    """Frames per second of the float64 scipy oracle on one host core (the
    numerical method pyeit runs per frame in the reference's process
    pool), each frame timed alone with the first, cache-cold frame
    dropped; credited at max(8, cpu_count) cores (the reference's
    documented 8-core minimum). Host work: ``device`` and ``seed`` are
    unused."""
    info = compact_mesh_nodes(prepare_mesh_info(mesh, ClassMap()))
    el = _electrodes(info)
    proto = create_protocol(16, 1, 1, "std")
    cond = np.where(info.cond == 2, 0.15, 0.3).astype(np.float64)
    per_frame, finite = [], True
    for i in range(frames):
        t0 = time.perf_counter()
        out = forward_solve_oracle(info.node, info.element, cond * (1 + 0.1 * i),
                                   el, proto.ex_mat, proto.meas_mat)
        per_frame.append(time.perf_counter() - t0)
        finite &= bool(np.isfinite(out).all())
    cores = max(8, os.cpu_count() or 1)
    single = rate_stats("oracle_frames_per_sec_single_core", 1.0,
                        per_frame[1:])
    return {
        **single,
        "baseline_cores": cores,
        "baseline_frames_per_sec":
            single["oracle_frames_per_sec_single_core"] * cores,
        "baseline_frames_per_sec_best":
            single["oracle_frames_per_sec_single_core_best"] * cores,
        "baseline_method": f"scipy sparse LU oracle x max(8, cpu_count) "
                           f"({cores} cores)",
        "check": finite,
    }


def bench_eit_batch(n_subjects=8, frames=1200, device="cuda", seed=0,
                    repeats=3) -> dict:
    """Batched same-bucket subjects: frames per second of one batched
    setup (build_batch) + solve for all subjects from prebuilt stiffness
    operators, and subjects per hour of the whole tail (mesh prep,
    electrodes, assembly, setup, solve:
    simulate_eit_monitoring_subjects). Subject s is the thorax jittered by
    3 % from seed ``seed + s``."""
    dev = resolve_device(device)
    meshes = [build_thorax_mesh(lc=7.0, jitter=0.03, seed=seed + s,
                                device=dev) for s in range(n_subjects)]
    sigma, lung, alphas, a0, proto = breathing_schedule(frames, dev)
    infos = [compact_mesh_nodes(prepare_mesh_info(m, ClassMap()))
             for m in meshes]
    els = [_electrodes(i) for i in infos]
    css = [ClassStiffness.build(i.node, i.element, i.cond, n_classes=5,
                                pad_nodes_to=512, pad_elems_to=2048,
                                device=dev) for i in infos]
    shapes = {tuple(cs.k_class.shape) for cs in css}
    if len(shapes) != 1:
        raise ValueError(f"subjects split across padding buckets: {shapes}")

    def spectral_job():
        return lowrank_solve_batch(LowRankSpectralSolver.build_batch(
            css, sigma[0], lung, els, proto.ex_mat, proto.meas_mat,
            [a0] * n_subjects), alphas)

    vs = spectral_job()  # warm-up
    spectral_times = timed_runs(spectral_job, repeats, dev)
    single = LowRankSpectralSolver.build(
        css[0], sigma[0], lung, els[0], proto.ex_mat, proto.meas_mat,
        a0).solve(alphas)
    got, ref = vs[0].cpu().numpy(), single.cpu().numpy()
    batch_err = float(np.abs(got - ref).max())
    batch_ok = bool(np.allclose(got, ref, rtol=BATCH_RTOL, atol=BATCH_ATOL))

    cfg = SimulationConfig(n_points=frames, n_spir=1, n_minutes=1,
                           pad_nodes_to=512, pad_elems_to=2048)
    outs = []

    def tail():
        outs.append(simulate_eit_monitoring_subjects(meshes, cfg, device=dev))

    tail()  # warm-up
    tail_times = timed_runs(tail, repeats, dev)
    finite = all(np.isfinite(v).all() and v.shape == (frames, 208)
                 for out in outs for v, _ in out)

    with counted_flops() as count:
        spectral_job()
    peaks = card_peaks(dev)
    t_spec = float(np.median(spectral_times))
    flops = count["setup"] + count["solve"]
    return {
        **rate_stats("batched_spectral_frames_per_sec_incl_setup",
                     n_subjects * frames, spectral_times),
        **rate_stats("batched_subjects_per_hour", n_subjects * 3600.0,
                     tail_times),
        "subjects": n_subjects,
        "workload_frames": frames,
        "padded_nodes": int(css[0].k_class.shape[-1]),
        "batched_spectral_flops": flops,
        "batched_spectral_tflops": tflops(flops, t_spec),
        "batched_spectral_mfu": mfu(peaks, t_spec, f32=flops),
        "batch_vs_single_max_abs": batch_err,
        "profile": profiled(spectral_job, dev),
        "check": batch_ok and bool(finite),
    }


def _seg_images(batch: int, imgsz: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0, 255, (batch, imgsz, imgsz)).astype(np.uint8)


@torch.inference_mode()
def device_labels(seg: TissueSegmenter, x: torch.Tensor) -> torch.Tensor:
    """``segment_labels``' device work on a resident uint8 batch: the same
    chunks (the ragged tail padded by repeating the last image), no host
    transfer. Returns the int8 label canvases."""
    b = x.shape[0]
    pad = (-b) % SEG_CHUNK if b > SEG_CHUNK else 0
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return torch.cat([seg._segment_labels_device(x[k:k + SEG_CHUNK], False)
                      for k in range(0, x.shape[0], SEG_CHUNK)])[:b]


def _labels_differ(seg: TissueSegmenter, e2e: np.ndarray,
                  coarse: torch.Tensor) -> int:
    """Pixels where the end-to-end labels differ from the device-only
    canvases, un-letterboxed as ``segment_labels`` does."""
    up = np.empty_like(e2e)
    seg._upsample_labels_into(up, coarse.cpu().numpy(), q=4)
    return int((up != e2e).sum())


def _network_flops(seg: TissueSegmenter, x: torch.Tensor) -> float:
    with counted_flops([seg]) as count:
        device_labels(seg, x)
    return count["network"]


def params_vs_eitx(seg: TissueSegmenter, seed: int):
    """The untrained segmenter's parameters against the JAX package's
    network of the same spec and seed (bench.py's ``bench_segmentation``
    network at seed 0; tests/data/torch_prng_fixture.npz, made from eitx):
    every leaf's bytes (sha256), float64 sum and sum of squares and first
    elements (the ulps between them), and whether the served network is
    exactly those parameters rounded to its dtype. None when the fixture
    holds no network of this spec and seed."""
    fx = torch_prng_check.load_fixture()
    meta = dict(fx["meta"]["segmenter_s"])
    if meta.pop("seed") != seed or seg.spec != yolov11_spec(
            meta["variant"], nc=meta["nc"], proto_stride=meta["proto_stride"]):
        return None
    state = flax_init_state(seg.spec, seed)
    out = torch_prng_check.leaf_errors(fx, "segmenter_s", state)
    served = seg.model.state_dict()
    out["served_is_rounded"] = all(
        torch.equal(served[n].cpu(), t.to(served[n].dtype))
        for n, t in state.items())
    out["equal"] = bool(out.get("names_equal") and not out["leaves_differ"]
                        and out["sums_equal"] and out["max_ulp"] == 0
                        and out["served_is_rounded"])
    return out


def bench_segmentation(batch=512, imgsz=512, repeats=5, device="cuda",
                       seed=0) -> dict:
    """Slices per second of the untrained YOLOv11-s segmenter of ``seed``
    (eitx's initial parameters for it: bench.py's network at seed 0),
    bfloat16, one view: end to end (``segment_labels``: host upload,
    device, readback, un-letterbox), on the device alone
    (``device_labels`` on a resident batch), and the host-to-device rate
    of the batch's bytes. The check also holds the network to the JAX
    package's (``params_vs_eitx``) where the fixture has it."""
    dev = resolve_device(device)
    seg = TissueSegmenter(imgsz=imgsz, max_det=64, dtype="bfloat16",
                          seed=seed, device=dev)
    imgs = _seg_images(batch, imgsz, seed)
    labels = seg.segment_labels(imgs, chunk=SEG_CHUNK)  # warm-up
    e2e = timed_runs(lambda: seg.segment_labels(imgs, chunk=SEG_CHUNK),
                     repeats, dev)
    x = torch.from_numpy(imgs).to(dev)
    coarse = device_labels(seg, x)  # warm-up
    dev_times = timed_runs(lambda: device_labels(seg, x), repeats, dev)
    link = None
    if dev.type == "cuda":
        link = rate_stats("h2d_link_mbytes_per_sec", imgs.nbytes / 1e6,
                          timed_runs(lambda: torch.from_numpy(imgs).to(dev),
                                     3, dev))
    flops = _network_flops(seg, x)
    peaks = card_peaks(dev)
    t_e2e, t_dev = float(np.median(e2e)), float(np.median(dev_times))
    differ = _labels_differ(seg, labels, coarse)
    vs_eitx = params_vs_eitx(seg, seed)
    line = {
        **rate_stats("segmentation_slices_per_sec_e2e", batch, e2e),
        **rate_stats("segmentation_slices_per_sec_device", batch, dev_times),
        **(link or {"h2d_link_mbytes_per_sec": None}),
        "batch": batch, "imgsz": imgsz, "chunk": SEG_CHUNK,
        "seg_flops_per_batch": flops,
        "seg_achieved_tflops_device": tflops(flops, t_dev),
        "seg_achieved_tflops_e2e": tflops(flops, t_e2e),
        "segmentation_mfu_device": mfu(peaks, t_dev, bf16=flops),
        "segmentation_mfu_e2e": mfu(peaks, t_e2e, bf16=flops),
        "labels_differ_px": differ,
        "params_vs_eitx": vs_eitx,
        "profile": profiled(lambda: seg.segment_labels(imgs, chunk=SEG_CHUNK),
                            dev),
        "check": differ == 0 and (vs_eitx is None or vs_eitx["equal"]),
    }
    if link:
        ceiling = link["h2d_link_mbytes_per_sec"] * 1e6 / (imgsz * imgsz)
        line["segmentation_link_ceiling_slices_per_sec"] = ceiling
        line["segmentation_e2e_link_ratio"] = (
            line["segmentation_slices_per_sec_e2e"] / ceiling)
    return line


def bench_serving_segmentation(batch=512, imgsz=512, repeats=5,
                               device="cuda", seed=0) -> dict:
    """Device slices per second of the checkpoint the service resolves
    (``find_checkpoint("tissue", imgsz)``: its own variant and proto
    stride), bfloat16, one view, on the same kind of batch; one end-to-end
    call for the check. A missing checkpoint raises."""
    dev = resolve_device(device)
    ckpt = find_checkpoint("tissue", imgsz)
    if ckpt is None:
        raise FileNotFoundError(f"no tissue checkpoint for imgsz {imgsz}")
    seg = TissueSegmenter(imgsz=imgsz, weights=ckpt, max_det=64,
                          dtype="bfloat16", device=dev)
    imgs = _seg_images(batch, imgsz, seed)
    labels = seg.segment_labels(imgs, chunk=SEG_CHUNK)
    x = torch.from_numpy(imgs).to(dev)
    coarse = device_labels(seg, x)  # warm-up
    dev_times = timed_runs(lambda: device_labels(seg, x), repeats, dev)
    flops = _network_flops(seg, x)
    peaks = card_peaks(dev)
    t_dev = float(np.median(dev_times))
    differ = _labels_differ(seg, labels, coarse)
    return {
        **rate_stats("serving_seg_slices_per_sec_device", batch, dev_times),
        "serving_seg_checkpoint": os.path.basename(ckpt),
        "batch": batch, "imgsz": imgsz, "chunk": SEG_CHUNK,
        "seg_flops_per_batch": flops,
        "serving_seg_achieved_tflops_device": tflops(flops, t_dev),
        "serving_seg_mfu_device": mfu(peaks, t_dev, bf16=flops),
        "labels_differ_px": differ,
        "profile": profiled(lambda: device_labels(seg, x), dev),
        "check": differ == 0,
    }


def _read(path) -> bytes | None:
    if not path or not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        return fh.read()


def bench_dataset_factory(n_subjects=4, imgsz=512, device="cuda", seed=0,
                          repeats=3) -> dict:
    """Subjects per hour of the request path, image in -> ``.dat`` out
    (Pipeline.run_jpg_png's whole tail at the serving PipelineConfig,
    serving checkpoints, 1200 voltage rows a subject), one card, steady
    state: a cold pass over ``n_subjects`` + 1 phantom slices (seeds 9100
    + ``seed`` + s) gives the first-hour rate, then ``repeats`` warm
    passes over the first ``n_subjects``, each request's ``Timer`` spans
    kept (their medians: where a request's time goes)."""
    dev = resolve_device(device)
    imgs = [(phantom_batch(1, imgsz, 12,
                           np.random.default_rng(9100 + seed + s),
                           device=dev)["images"][0, ..., 0]
             * 255).astype(np.uint8)
            for s in range(n_subjects + 1)]
    with tempfile.TemporaryDirectory(prefix="eitx_bench_") as results:
        base = PipelineConfig()
        cfg = dataclasses.replace(
            base,
            model=dataclasses.replace(
                base.model,
                axial_weights_512=find_checkpoint("tissue", 512),
                axial_weights_256=find_checkpoint("tissue", 256),
            ),
            save_dataset=True,
            results_dir=results,
        )
        pipe = Pipeline(cfg, device=dev)
        t0 = time.perf_counter()
        cold = [pipe.run_jpg_png(img) for img in imgs]
        _sync(dev)
        t_cold = time.perf_counter() - t0
        cold_dat = [_read(a.get("saved_file_name")) for a in cold]
        answers, spans = [], collections.defaultdict(list)

        def warm_pass():
            answers.append([])
            for s in range(n_subjects):
                timer = Timer()  # the request's own spans: no extra work
                answers[-1].append(pipe.run_jpg_png(imgs[s], timer=timer))
                for name, sec in timer.as_dict().items():
                    spans[name].append(sec)

        warm = timed_runs(warm_pass, repeats, dev)
        statuses = [a.get("status") for a in cold] + [
            a.get("status") for p in answers for a in p]
        equal = [[_read(a.get("saved_file_name")) == cold_dat[s]
                  and cold_dat[s] is not None for s, a in enumerate(p)]
                 for p in answers]
        seg = pipe._segmenter_for(imgs[0])
        with counted_flops([seg]) as count:
            pipe.run_jpg_png(imgs[0])
        prof = profiled(lambda: pipe.run_jpg_png(imgs[0]), dev)
    peaks = card_peaks(dev)
    t_subject = float(np.median(warm)) / n_subjects
    fem = count["setup"] + count["solve"]
    return {
        **rate_stats("pipeline_subjects_per_hour_e2e", n_subjects * 3600.0,
                     warm),
        "pipeline_subjects_per_hour_cold": (n_subjects + 1) * 3600.0 / t_cold,
        "subjects": n_subjects, "imgsz": imgsz,
        "statuses": dict(collections.Counter(statuses)),
        "dat_equal_to_cold": equal,
        "subject_seconds": t_subject,
        # median over the warm requests; "simulation" holds the .dat write
        "span_seconds": {k: float(np.median(v)) for k, v in spans.items()},
        "pipeline_network_flops_per_subject": count["network"],
        "pipeline_fem_flops_per_subject": fem,
        "pipeline_tflops": tflops(count["network"] + fem, t_subject),
        "pipeline_mfu": mfu(peaks, t_subject, bf16=count["network"], f32=fem),
        "profile": prof,
        "check": all(s == "success" for s in statuses)
        and all(all(p) for p in equal),
    }


def bench_greit(mesh, frames=12000, repeats=3, device="cuda", seed=0) -> dict:
    """GREIT images per second for device-resident voltage frames (seeded
    normal draws) through the trained matrix, and the matrix's build: the
    first in the process, then a different mesh of the same padding
    bucket (the thorax jittered from seed 17 + ``seed``)."""
    dev = resolve_device(device)
    info, sigma_ref, el, proto = monitoring_linearization(mesh)
    t0 = time.perf_counter()
    im = GreitImager.build(info.node, info.element, sigma_ref, el,
                           proto.ex_mat, proto.meas_mat, device=dev)
    _sync(dev)
    t_first = time.perf_counter() - t0
    mesh2 = build_thorax_mesh(lc=7.0, jitter=0.03, seed=17 + seed, device=dev)
    info2, sigma2, el2, proto2 = monitoring_linearization(mesh2)
    builds = timed_runs(lambda: GreitImager.build(
        info2.node, info2.element, sigma2, el2, proto2.ex_mat,
        proto2.meas_mat, device=dev), repeats, dev)
    dv_host = np.random.default_rng(seed).standard_normal(
        (frames, im.R.shape[1])).astype(np.float32)
    dv = torch.from_numpy(dv_host).to(dev)
    mask = torch.as_tensor(im.mask, device=dev).to(im.R.dtype)
    img = _apply(im.R, mask, dv)  # warm-up
    _sync(dev)
    times = timed_runs(lambda: _apply(im.R, mask, dv), repeats, dev)
    ref = (dv_host.astype(np.float64) @ im.R.double().cpu().numpy().T
           ).reshape(frames, im.npx, im.npx) * im.mask
    err = float(np.abs(img.cpu().numpy() - ref).max() / np.abs(ref).max())
    flops = 2.0 * frames * im.R.shape[0] * im.R.shape[1]
    return {
        **rate_stats("greit_images_per_sec_device", frames, times),
        **seconds_stats("greit_matrix_build_seconds", builds),
        "greit_matrix_build_first_seconds": t_first,
        "frames": frames,
        "greit_apply_flops": flops,
        "greit_apply_tflops": tflops(flops, float(np.median(times))),
        "greit_vs_float64_of_scale": err,
        # one apply is ~0.1 ms of device work, too short a window for the
        # profiler to see its kernels: the window holds GREIT_PROFILE_APPLIES
        "profile": profiled(lambda: [_apply(im.R, mask, dv)
                                     for _ in range(GREIT_PROFILE_APPLIES)],
                            dev),
        "profile_applies": GREIT_PROFILE_APPLIES,
        "check": err < GREIT_OF_SCALE,
    }


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--section", action="append", choices=SECTIONS,
                   help="run only this section (repeatable; default all)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    names = [s for s in SECTIONS if not args.section or s in args.section]
    t_start = time.perf_counter()
    card = card_name_and_limit() if dev.type == "cuda" else None
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    mesh = None
    if any(s in MESH_SECTIONS for s in names):
        mesh = build_thorax_mesh(device=dev)
    checks, results = {}, {}
    for name in names:
        t0 = time.perf_counter()
        fn = globals()[name]
        head = (mesh,) if name in MESH_SECTIONS else ()
        line = fn(*head, device=dev, seed=args.seed)
        results[name] = line
        checks[name] = bool(line["check"])
        emit({"section": name, **line, "seconds": time.perf_counter() - t0,
              "device": kind, "card": card})
    vs_baseline = None
    if "bench_eit" in results and "bench_eit_oracle" in results:
        vs_baseline = (results["bench_eit"]["eit_forward_frames_per_sec"]
                       / results["bench_eit_oracle"]["baseline_frames_per_sec"])
    emit({"section": "summary", "sections": names, "checks": checks,
          "ok": all(checks.values()), "vs_baseline": vs_baseline,
          "seed": args.seed, "bench_wall_s": time.perf_counter() - t_start,
          "device": kind, "card": card})
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
