"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives eitx_torch's main paths and holds every hand-written kernel against
its plain PyTorch version:
  - ``Pipeline.run_jpg_png`` on a 512x512 axial slice with the trained
    YOLOv11-n tissue segmenter (bf16, per-class conf, 4 flip views),
    default mesh (lc 7) and the default simulation (16 electrodes, 100
    points x 12 breaths, low-rank spectral solve);
  - ``Pipeline.run_dicom_sequences_auto`` on a thoracic CT series of 512
    slices of 512x512 int16 (~268 MB of pixels, made from a seed and
    zipped in memory): ingest, frontal view, the trained rib detector,
    slice selection, HU window and body mask, then the same tail;
  - one request each of the custom-offset, DICOM-frame, NIfTI and
    zipped-image modes;
  - the dataset factory ``pipeline.batch.generate_batch`` on nine
    synthetic thorax subjects in two node buckets, at the serving
    simulation defaults, twice;
  - every forward-solver family of ``eitx_torch.fem`` once;
  - inverse imaging (difference, GREIT, Gauss-Newton) of the serving
    monitoring on the real slice at the serving lc 7;
  - the HTTP service over the serving ``Pipeline``, and the pixel-level
    eval harness;
  - training: the YOLOv11-n segmenter at 512^2 and the rib detector at
    640^2 through ``Trainer``, ``device_batches`` and ``fit``;
  - the sharded paths of ``eitx_torch.parallel`` on a world of one card
    (NCCL): ``Trainer(mesh=...)``, sharded monitoring, segmentation and
    the factory's group solve; then the profiling and dataset scripts;
  - the six examples of ``examples/torch/``;
  - bench_torch.py's single-subject FEM and dataset-factory sections.

Phases, one JSON line each; any failure raises and exits non-zero:
  env       torch / CUDA versions, the card, the kernel and native builds,
            ptxas' registers / shared memory / spills of each CUDA kernel
  kernel_pip  the point-in-polygon kernel vs its plain version at the main
            path's width (Q 32768, C 32, P 512) on random polygons, where
            every edge is live (the dense worst case), and on known points;
            its prologue's live-edge list vs a plain selection
  kernel_pip  the same on edge cases: level edges, points level with a
            vertex, signed zeros, dead polygons, NaN, odd C / P / Q
  mesh      create_mesh on tests/data/real_slice_polygons.txt at lc 10:
            exact node / triangle / class goldens, kernel launched
  fem       spectral solve on that mesh vs the float64-oracle goldens
  pipeline  three run_jpg_png requests: per-stage times of requests 2-3,
            kernel launches, byte-equal .dat files of 1200 x 208
  profile   a fourth request under torch.profiler: device busy time, idle
            share, top device kernels; the .dat writer timed alone
  kernel_pip  the kernel vs its plain version on the inputs the main path
            gave it in request 1
  labels    the segmenter in float32 (TF32 off) vs the JAX package's
            float32 labels committed in tests/data/torch_smoke_512.npz;
            then at the serving dtype, bfloat16, vs the JAX package's
            bfloat16 labels there (agreement, per-class IoU), with the
            CPU port's labels beside the card's
  image     body mask (both flips), HU window and min-max normalization of
            a 512x512 HU phantom: the card vs the same code on the CPU,
            equal on every pixel; the body mask's time, its labelling and
            flood steps
  ribs      the rib detector at the serving settings and in float32 (TF32
            off) vs the JAX package's boxes and slice pick committed in
            tests/data/torch_series_512.npz
  series    three run_dicom_sequences_auto requests on the 512-slice
            series: the fixture's pick and body mask, spans, byte-equal
            .dat files, one kernel launch per request; a profiled fourth
  modes     run_dicom_sequences_custom (offset 1), run_dicom_frame,
            run_nii, run_jpg_png_zip: success and .dat shape
  factory   nine thorax subjects meshed on the card (eight at lc 7, one
            at lc 5: two node buckets), then generate_batch twice into
            fresh directories: every subject done and batched, byte-equal
            .dat files of 1200 x 208, frames 0 and 50 against the float64
            oracle, each subject against its own single-subject run;
            per-stage times, peak memory, subjects per hour
  solvers   on the mesh phase's mesh, 8 frames: direct batched Cholesky,
            full and low-rank spectral, float64 direct and spectral vs the
            goldens and the float64 oracle; CG vs the direct solve and at
            its defaults (iterations, residual); CEM direct vs spectral
            (float64; float32 measured);
            admittance with eps_r = 0 vs the real solver, a 4-frequency
            sweep and Sheffield monitoring; each family's time
  inverse   the real slice at lc 7 (~4,200 nodes), the serving monitoring
            (1200 x 208): reconstruct_monitoring (Jacobian and images vs
            float64 on the card, the lungs' change vs their schedule),
            greit_monitoring (mask equal to the CPU's, R vs the CPU's, lung
            pixels vary most, .npz round trip), gauss_newton_absolute on a
            +50 % lung inclusion (residual drop, contrast, vs the CPU, no
            device wait inside the loop); warm times and images per second
  serve     EitxHTTPServer over the serving Pipeline: /health, /ui, three
            sequential and three concurrent multipart image requests
            (byte-equal .dat files, equal to a direct call's; the three
            inside the pipeline at once, no lock), the series
            zip through the client (the fixture's pick), /createMesh, a
            bad upload (400) and an unknown route (404); one kernel
            launch per request; HTTP overhead over the direct call
  eval      PixelLevelEvaluator (trained 512 checkpoint, batch 16) on 32
            flips and shifts of the 512^2 phantom with YOLO labels traced
            from the fixture's labels: equal to evaluate_dataset of the
            card's labels; images per second
  prng      (in the train phase) the train phase's trainer and the
            untrained YOLOv11-s segmenter of seed 0 against the JAX
            package's initial parameters, and the first batches of a seeded
            stream against its batches (tests/data/torch_prng_fixture.npz);
            the stream's draws with no device sync; the host's init time
  train     the segmenter at train_tissue's 512 defaults (batch 8, TAL,
            mask top-K 160 at mask resolution 256) on a store of 32
            phantoms labelled on the card, fed by device_batches: 3 warm-up
            steps, 20 timed steps through fit with the EMA (ms per step by
            CUDA events, images per second, peak memory, first and last
            loss), 5 profiled steps (idle share, top kernels); one step on
            the card against the same step on the CPU (two images); a
            .train round trip that continues as the run it came from; the
            deployment file labelling the 512^2 phantom; the rib detector
            at 640 (batch 4, 16 rib phantoms), 10 timed steps
  parallel  eitx_torch.parallel on a world of one card (NCCL, joined
            through a FileStore): Trainer on a (data, model) = (1, 1)
            mesh against the meshless Trainer from one init on one batch
            stream (3 steps: losses at the train phase's bounds, batch
            statistics after the first; 5 more timed by CUDA events: ms
            per step, peak memory); sharded_eit_monitoring of the serving
            schedule's frames 12 times over (1200, as the .dat's rows) on
            an lc-7 thorax equal to forward_solve_batched;
            sharded_segment_labels of 16 flips and shifts of the phantom
            (trained 512 checkpoint, serving settings) against
            segment_labels; the factory's nine thorax subjects meshed on
            the card, their low-rank solvers built per node bucket and
            sharded_group_solve: every .dat (1200 x 208) byte-equal to
            the subject's own solve. At a world of one a rank's block is
            the whole run, so the blocks of a world of 4 are also
            computed one after another and held to the same results
            (monitoring: time and peak memory of each block)
  scripts   profile_seg (512, batch 16, 3 repeats), profile_setup (batch
            8, 3 repeats), eval_ood_fixture at 512 with one seed on the
            trained checkpoint (test_ood_fixture.py's ratchets),
            build_datasets frontal on the series zip (512 images)
  examples  the six examples of examples/torch/ at the sizes of
            tests/test_torch_examples.py: results, kernel launches, each
            one's wall time
  bench     bench_torch.main for bench_eit and bench_dataset_factory at
            their full sizes, in this process: each section's line, every
            check true, kernel launches
Every phase prints its seconds. Then the kernels line, the card's name
and power limit, and the result line. Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
WEIGHTS = os.path.join(ROOT, "weights")
# the series of the rib and series phases: torch_series_phantom.
# series_volume(SERIES_SEED, 512, 512); tests/data/torch_series_512.npz
# holds the JAX package's answers for it
SERIES_SLICES = SERIES_SIZE = 512

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the crossing test of one (point, edge) pair: y - y1, 1 product,
# 1 division, 1 addition and 3 comparisons (y1 > y, y2 > y, x < xc); the
# select and the parity update are not counted
PIP_OPS_PER_PAIR = 7
# terms of one edge, whatever the point: x2 - x1, y2 - y1 and dy == 0
PIP_OPS_PER_EDGE = 3
# the fp32 peak counts a fused multiply-add as two operations; none of the
# crossing's operations may fuse, so they issue at half the peak at best
PIP_ISSUE_SHARE = 0.5

GOLD_NODES, GOLD_TRIS = 2107, 4041
GOLD_HIST = {0: 243, 1: 563, 2: 1669, 3: 1565, 4: 1}
GOLD_ROW0 = np.array(
    [3.27767618, 0.16383494, 0.15325824, 0.12928992, 0.03966795, 0.02340173])
GOLD_ROW5 = np.array(
    [0.07548676, 0.08194821, 0.05308934, 0.31663108, 1.00702802, 3.41541427])
GOLD_SUM = 1194.555605
GOLD_ABSMAX = 8.415208
# the float64 routes against the float64 oracle, scale-relative: the
# low-rank solver drops the lung block's eigenvalues below 1e-7 of the
# largest (its solves measure 4e-9 to 7e-9); the direct solve meets 1e-12
F64_BOUND = 1e-7


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one ``fn()`` in ms between two CUDA events: device
    time, or the host's time to enqueue the call where that is longer."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, n: int = 50, rounds: int = 5) -> float:
    """Device time of one ``fn()`` in ms when calls follow one another.

    A call of a few microseconds takes the host longer to enqueue than the
    device to run, and two events around it time the host. So the device
    is first kept busy with a spin kernel while ``n`` calls are queued
    behind it; the two events around those calls then see device time
    alone. Median of ``rounds``."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    spin_cycles = int(max(2 * host_s, 2e-3) * 2e9)  # clock under 2 GHz
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def pip_bound_ms(q: int, c: int, p: int, edges: int) -> tuple:
    """Least time for ``edges`` edges per point (c * p: every edge), the
    per-edge terms of all c * p edges, and each byte moved once."""
    ops = q * edges * PIP_OPS_PER_PAIR + c * p * PIP_OPS_PER_EDGE
    nbytes = q * 2 * 4 + c * p * 2 * 4 + q * c
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def ptxas_figures(log: str) -> list:
    """Registers, shared memory and spills of each kernel, from the lines
    ``nvcc -Xptxas -v`` printed."""
    import re

    figures = []
    for name, body in re.findall(
            r"Compiling entry function '(\w+)'(.*?)(?=ptxas info\s*: Compiling|\Z)",
            log, flags=re.S):
        used = re.search(r"Used (\d+) registers", body)
        smem = re.search(r"(\d+) bytes smem", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          body)
        kernel = re.search(r"pip_[a-z]+_kernel(ILi\d+E)?", name)
        figures.append(dict(
            kernel=kernel.group(0) if kernel else name,
            registers=int(used.group(1)) if used else None,
            smem_bytes=int(smem.group(1)) if smem else 0,
            spill_stores=int(spill.group(1)) if spill else None,
            spill_loads=int(spill.group(2)) if spill else None))
    return figures


def phase_env():
    import torch

    from eitx_torch.contours import trace
    from eitx_torch.mesh import pip, triangulate

    t0 = time.perf_counter()
    # one compiler process per source, all started together
    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = [pool.submit(pip.load_kernel),
                   pool.submit(triangulate._load_native),
                   pool.submit(trace._load_native)]
        libs = [f.result() for f in futures]
    build_s = time.perf_counter() - t0
    check(all(lib is not None for lib in libs), "a native library did not build")
    ptxas = ptxas_figures(pip.kernel_build_log())
    check(len(ptxas) >= 3, f"ptxas reported {len(ptxas)} kernels")
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), gpu=gpu_name_and_limit(),
         build_s=round(build_s, 3), nvcc_flags=pip.NVCC_FLAGS, ptxas=ptxas)


def _random_polys(rng, c: int, p: int) -> np.ndarray:
    centres = rng.uniform(64, 448, (c, 1, 2))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (c, p)), axis=1)
    rad = rng.uniform(10, 120, (c, p))
    return centres + np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)


def _sorted_rows(rows) -> np.ndarray:
    """Rows of a float32 matrix as bit patterns, sorted: equal sets of rows
    give equal arrays, NaN and -0.0 included."""
    bits = np.ascontiguousarray(rows.cpu().numpy()).view(np.int32)
    return bits[np.lexsort(bits.T[::-1])]


def check_live_edges(polys) -> int:
    """The prologue's live-edge list vs the plain selection y2 != y1 of the
    same polygons: equal offsets, and per polygon the same set of records
    (their order inside a polygon is free). Returns the number of
    records."""
    import torch

    from eitx_torch.mesh import pip

    records, offsets = pip.live_edges(polys)
    want_records, want_offsets = pip.live_edges_ref(polys)
    torch.cuda.synchronize()
    check(torch.equal(offsets, want_offsets), "live-edge offsets differ")
    bounds = offsets.tolist()
    for c in range(polys.shape[0]):
        lo, hi = bounds[c], bounds[c + 1]
        check(np.array_equal(_sorted_rows(records[lo:hi]),
                             _sorted_rows(want_records[lo:hi])),
              f"live edges of polygon {c} differ")
    return bounds[-1]


def compare_pip(points, polys, timed: bool = True) -> dict:
    """Kernel vs plain version on the same inputs: every element must
    agree, and the prologue's list must be the plain selection. Returns the
    comparison's numbers, with times where ``timed``."""
    import torch

    from eitx_torch.mesh import pip

    got = pip.points_in_polys(points, polys)
    ref = pip.points_in_polys_ref(points, polys)
    torch.cuda.synchronize()
    err = int((got.to(torch.int8) - ref.to(torch.int8)).abs().max().item())
    check(torch.equal(got, ref), "pip kernel disagrees with its plain version")
    list_edges = check_live_edges(polys)
    q, (c, p) = points.shape[0], polys.shape[:2]
    if not timed:
        return dict(shape=[q, c, p], max_abs_err=err, list_edges=list_edges,
                    inside_fraction=float(ref.float().mean().item()))
    bound, bound_by, ops, nbytes = pip_bound_ms(q, c, p, c * p)
    live_bound, live_by, live_ops, _ = pip_bound_ms(q, c, p, list_edges)
    # device time with calls queued back to back: a call this short takes
    # the host longer to enqueue than the device to run
    ms = device_ms(lambda: pip.points_in_polys(points, polys))
    prologue_ms = device_ms(lambda: pip.live_edges_padded(polys))
    # one call between two events, the host's enqueue time included
    call_ms = cuda_ms(lambda: pip.points_in_polys(points, polys))
    plain_ms = cuda_ms(lambda: pip.points_in_polys_ref(points, polys),
                       reps=5, warmup=1)
    # edges of nonzero length on polygons inside the scene: the tests the
    # answer depends on (padding polygons sit at -1e7, padding vertices
    # repeat the last one)
    live = polys[:, :, 0] > -1e6
    moved = (torch.roll(polys, -1, dims=1) != polys).any(dim=2)
    return dict(shape=[q, c, p], max_abs_err=err, ms=ms, call_ms=call_ms,
                prologue_ms=prologue_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, ops=ops, bytes=nbytes,
                issue_bound_ms=bound / PIP_ISSUE_SHARE
                if bound_by == "operations" else bound,
                live_bound_ms=live_bound, live_bound_by=live_by,
                live_ops=live_ops,
                inside_fraction=float(ref.float().mean().item()),
                live_polygons=int(live[:, 0].sum().item()),
                live_edges=int((live & moved).sum().item()),
                list_edges=list_edges)


def phase_kernel(dev):
    import torch

    rng = np.random.default_rng(0)
    q, c, p = 32768, 32, 512
    points = torch.as_tensor(rng.uniform(0, 512, (q, 2)), dtype=torch.float32,
                             device=dev)
    polys = torch.as_tensor(_random_polys(rng, c, p), dtype=torch.float32,
                            device=dev)
    res = compare_pip(points, polys)
    from eitx_torch.mesh import pip

    known = pip.points_in_polys(
        torch.tensor([[5.0, 5.0], [15.0, 5.0], [-1.0, 3.0], [9.9, 9.9]],
                     device=dev),
        torch.tensor([[[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [0.0, 10.0]]],
                     device=dev),
    )[:, 0].tolist()
    check(known == [True, False, False, True], f"known points gave {known}")
    emit("kernel_pip", inputs="random", known_points_ok=True, **res)


def pip_edge_cases() -> list:
    """(name, points (Q, 2), polys (C, P, 2)) float32 arrays that press on
    the kernel's rules: what the prologue drops, where the straddle test
    ties (signed zeros included) and the shapes its tiles and passes do not
    divide."""
    rng = np.random.default_rng(5)

    def pts(q, lo=0.0, hi=512.0):
        return rng.uniform(lo, hi, (q, 2)).astype(np.float32)

    def polys(c, p):
        return _random_polys(rng, c, p).astype(np.float32)

    cases = []
    # stairs on an integer grid: every other edge is level; points on the
    # grid (level with vertices, on edges) and between its lines
    stairs = np.array([[0, 0], [6, 0], [6, 2], [4, 2], [4, 4], [2, 4],
                       [2, 6], [0, 6]], np.float32)
    grid = np.stack(np.meshgrid(np.arange(-1, 8, 0.5), np.arange(-1, 8, 0.5)),
                    -1).reshape(-1, 2).astype(np.float32)
    cases.append(("level edges", grid,
                  np.stack([stairs, stairs[::-1] + 1, stairs * 0.5 + 3])))
    # points whose y is exactly a vertex's y
    ring = polys(3, 64)
    level = pts(192)
    level[:, 1] = ring[:, :, 1].reshape(-1)
    cases.append(("points level with a vertex", level, ring))
    # a polygon whose vertices are all equal, between live ones; -0.0 / 0.0
    mixed = polys(4, 32)
    mixed[1] = mixed[1, :1]
    mixed[2, :, 1] = np.where(np.arange(32) % 2 == 0, 0.0, -0.0)
    cases.append(("all-equal and level polygons", pts(1000), mixed))
    # signed zeros: points at y = -0.0 and +0.0 against rings round the
    # origin whose vertices near the axis are snapped to +0.0 and -0.0
    # (0.0 > -0.0 is false: a point level with a vertex, whatever the
    # signs)
    zeros = polys(6, 64) * 0.01 - rng.uniform(1.0, 4.0, (6, 1, 2)).astype(
        np.float32)
    near = np.abs(zeros[:, :, 1]) < 0.3
    zeros[:, :, 1] = np.where(
        near, np.where(np.arange(64) % 2 == 0, 0.0, -0.0), zeros[:, :, 1])
    on_axis = pts(1024, -6.0, 2.0)
    # three of four points on the axis; the fourth widens its warp's reach
    on_axis[:, 1] = np.where(np.arange(1024) % 4 == 3, on_axis[:, 1] / 3.0,
                             np.where(np.arange(1024) % 2 == 0, -0.0, 0.0))
    cases.append(("signed zeros", on_axis, zeros.astype(np.float32)))
    # every polygon dead: the caller's far-away padding, and level ones
    dead = np.full((8, 64, 2), -1e7, np.float32)
    dead[4:, :, 0] = rng.uniform(0, 512, (4, 64))
    dead[4:, :, 1] = 100.0
    cases.append(("every polygon dead", pts(1000), dead))
    # the caller's padding around real rings
    padded = np.full((8, 64, 2), -1e7, np.float32)
    padded[:3, :40] = polys(3, 40)
    padded[:3, 40:] = padded[:3, 39:40]
    cases.append(("padded buckets", pts(1000), padded))
    # NaN and infinite coordinates: every comparison with a NaN is false
    odd = polys(3, 16)
    odd[0, 3, 1] = np.nan
    odd[1, 5, 0] = np.nan
    odd[2, 2] = [np.inf, -np.inf]
    odd[2, 9, 1] = np.inf
    strange = pts(256)
    strange[:4] = [[np.nan, 200.0], [200.0, np.nan], [np.inf, 200.0],
                   [200.0, -np.inf]]
    cases.append(("NaN and infinite coordinates", strange, odd))
    for c, p, q in [(1, 4, 5), (1, 700, 1000), (40, 4, 1000), (40, 700, 1000),
                    (48, 33, 129), (3, 64, 70001), (3, 64, 140003)]:
        cases.append((f"C {c}, P {p}, Q {q}", pts(q), polys(c, p)))
    return cases


def phase_edge_cases(dev):
    import torch

    results = []
    for name, points, polys in pip_edge_cases():
        res = compare_pip(torch.as_tensor(points, device=dev),
                          torch.as_tensor(polys, device=dev), timed=False)
        results.append(dict(case=name, **res))
    emit("kernel_pip", inputs="edge cases", cases=results)


def real_polygons():
    with open(os.path.join(DATA, "real_slice_polygons.txt")) as fh:
        return [ln.strip() for ln in fh if ln.strip() and not ln.startswith("#")]


def phase_mesh(dev):
    from eitx_torch.mesh import create_mesh, pip

    pip.pip_launches = 0
    t0 = time.perf_counter()
    _, mesh = create_mesh(["1", "1"], real_polygons(), 10, 1.3, 1, True,
                          show_meshing_result_method="no", device=dev)
    dt = time.perf_counter() - t0
    launches = pip.pip_launches
    nodes = np.asarray(mesh["NODES"]).shape[0]
    tris = np.asarray(mesh["TRIANGLES"]).shape[0]
    hist = dict(sorted(collections.Counter(
        np.asarray(mesh["CLASS"]).tolist()).items()))
    check(nodes == GOLD_NODES and tris == GOLD_TRIS, f"{nodes} nodes, {tris} tris")
    check(hist == GOLD_HIST, f"class histogram {hist}")
    check(launches > 0, "create_mesh did not launch the pip kernel")
    emit("mesh", nodes=nodes, tris=tris, hist=hist, pip_launches=launches,
         s=dt)
    return mesh


def phase_fem(dev, mesh):
    from eitx_torch.core.config import SimulationConfig
    from eitx_torch.fem import simulate_eit_monitoring

    cfg = SimulationConfig(n_points=8, n_spir=1, n_minutes=1)
    v, dt = simulate_eit_monitoring(mesh, cfg, device=dev)
    check(v.shape == (8, 208) and np.isfinite(v).all(), f"voltages {v.shape}")
    rel0 = np.abs(v[0][:6] - GOLD_ROW0) / np.abs(GOLD_ROW0)
    rel5 = np.abs(v[5][-6:] - GOLD_ROW5) / np.abs(GOLD_ROW5)
    rel_sum = abs(v.sum() - GOLD_SUM) / GOLD_SUM
    rel_max = abs(np.abs(v).max() - GOLD_ABSMAX) / GOLD_ABSMAX
    check(rel0.max() < 2e-2 and rel5.max() < 2e-2, "oracle rows off")
    check(rel_sum < 2e-3 and rel_max < 2e-3, "oracle sum / abs-max off")
    emit("fem", rel_row0=float(rel0.max()), rel_row5=float(rel5.max()),
         rel_sum=float(rel_sum), rel_absmax=float(rel_max), s=dt)


@contextlib.contextmanager
def recorded_pip_inputs():
    """While open, keeps the (points, polys) of the first call the triangle
    classifier makes to the kernel's wrapper; yields the list they land
    in."""
    import eitx_torch.mesh.classify as classify

    recorded = []
    launch = classify.points_in_polys

    def record(points, polys):
        if not recorded:
            recorded.append((points.clone(), polys.clone()))
        return launch(points, polys)

    classify.points_in_polys = record
    try:
        yield recorded
    finally:
        classify.points_in_polys = launch


def phase_pipeline(dev, image):
    import torch

    from eitx_torch.core.config import ModelConfig, PipelineConfig
    from eitx_torch.core.timing import Timer
    from eitx_torch.fem.forward import write_dat
    from eitx_torch.mesh import pip
    from eitx_torch.pipeline import Pipeline

    with tempfile.TemporaryDirectory() as results:
        cfg = PipelineConfig(
            model=ModelConfig(axial_weights_512=os.path.join(
                WEIGHTS, "tissue_n_512.msgpack")),
            results_dir=results,
        )
        t0 = time.perf_counter()
        pipe = Pipeline(cfg, device=dev)
        load_s = time.perf_counter() - t0
        with recorded_pip_inputs() as recorded:
            pip.pip_launches = 0
            answers, spans, walls = [], [], []
            for _ in range(3):
                timer = Timer()
                t0 = time.perf_counter()
                answers.append(pipe.run_jpg_png(image, timer=timer))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                spans.append(timer.as_dict())
            launches = pip.pip_launches
        dats = [open(a["saved_file_name"], "rb").read() for a in answers]
        v = np.loadtxt(answers[0]["saved_file_name"])
        profile = profiled_request(lambda: pipe.run_jpg_png(image))
        t0 = time.perf_counter()
        write_dat(os.path.join(results, "probe.dat"), v[:100], n_repeats=12)
        profile["write_dat_1200_rows_s"] = time.perf_counter() - t0
    check(launches == 3, f"pip kernel launched {launches} times in 3 requests")
    check(all(a["status"] == "success" for a in answers), "request failed")
    check(v.shape == (1200, 208) and np.isfinite(v).all(), f".dat {v.shape}")
    check(dats[0] == dats[1] == dats[2], ".dat files differ between requests")
    classes = sorted({ln.split()[0] for ln in answers[0]["text_data"][2:]})
    check(len(classes) >= 2, f"classes {classes}")
    emit("pipeline", load_s=load_s, request_s=walls, spans_req2=spans[1],
         spans_req3=spans[2], pip_launches=launches, dat_rows=v.shape[0],
         dat_cols=v.shape[1], dat_bytes_equal=True, classes=classes,
         seg_time=[a["segmentation_time"] for a in answers],
         sim_time=[a["simulation_time"] for a in answers],
         max_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    emit("profile", **profile)
    return launches, recorded[0]


def _busy_ms(events) -> float:
    """Union of the device's kernel and copy intervals, in ms."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy / 1e3


def profiled_request(request, top: int = 10) -> dict:
    """One more warm request (``request()``) under torch.profiler: its
    wall time, the device's busy time, the idle share and the ``top``
    device kernels with the most time. Runs after the kernel counts are
    read."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy = _busy_ms(events)
    check(busy > 0, "the profiled request shows no device time")
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
            kernels[e.name][1] += 1
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1.0 - busy / wall_ms,
                top_kernels_ms=[{"name": n[:80], "ms": ms, "count": k}
                                for n, (ms, k) in ranked])


def _per_class_iou(got, ref) -> dict:
    return {int(c): float(((got == c) & (ref == c)).sum()
                          / max(1, ((got == c) | (ref == c)).sum()))
            for c in range(4)}


def phase_labels(dev, image, ref_labels, ref_bf16):
    """The segmenter at the serving settings against the JAX package's
    labels in the fixture: in float32 (TF32 off) and at the serving dtype,
    bfloat16, where the CPU port's labels are printed beside the card's."""
    from eitx_torch.core.config import ModelConfig
    from eitx_torch.models.yolo.infer import TissueSegmenter

    m = ModelConfig()
    kw = dict(weights=os.path.join(WEIGHTS, "tissue_n_512.msgpack"),
              conf=m.axial_conf_per_class, max_det=m.max_detections,
              tta_fill=m.axial_tta_fill)
    seg = TissueSegmenter(512, dtype="float32", device=dev, **kw)
    (labels, _), flags = tf32_flags_of(
        seg.model, lambda: seg.predict_labels(image))
    check(flags and not any(a or b for a, b in flags),
          f"float32 inference ran with TF32 settings {flags}")
    agree = float((labels == ref_labels).mean())
    check(agree >= 0.99, f"float32 label agreement {agree}")
    emit("labels", dtype="float32", agreement=agree, forward_passes=len(flags),
         classes=sorted(int(c) for c in np.unique(labels)))

    check(m.dtype == "bfloat16", f"serving dtype {m.dtype}")
    card, _ = TissueSegmenter(512, dtype=m.dtype, device=dev,
                              **kw).predict_labels(image)
    cpu, _ = TissueSegmenter(512, dtype=m.dtype, device="cpu",
                             **kw).predict_labels(image)
    agree = float((card == ref_bf16).mean())
    check(agree >= 0.99, f"bfloat16 label agreement {agree}")
    check(set(np.unique(card)) == set(np.unique(ref_bf16)),
          f"bfloat16 classes {np.unique(card)}")
    emit("labels", dtype=m.dtype, agreement=agree,
         per_class_iou=_per_class_iou(card, ref_bf16),
         pixels_that_differ=int((card != ref_bf16).sum()),
         cpu_port_agreement=float((cpu == ref_bf16).mean()),
         cpu_port_per_class_iou=_per_class_iou(cpu, ref_bf16),
         card_vs_cpu_port=float((card == cpu).mean()))


def tf32_flags_of(network, run):
    """``run()`` with a hook on ``network`` that notes the TF32 settings
    each forward pass sees; returns (result, flags)."""
    import torch

    flags = []
    hook = network.register_forward_pre_hook(lambda *_: flags.append(
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32)))
    try:
        return run(), flags
    finally:
        hook.remove()


def count_fixpoint_steps(run) -> tuple:
    """``run()`` with the image package's fixpoint loops counted: returns
    (result, steps of each loop in the order they ran)."""
    import eitx_torch.image.cc as cc

    steps = []
    inner = cc.fixpoint

    def counting(step, x):
        steps.append(0)

        def counted(y):
            steps[-1] += 1
            return step(y)

        return inner(counted, x)

    cc.fixpoint = counting
    try:
        return run(), steps
    finally:
        cc.fixpoint = inner


def phase_image(dev):
    """CT preprocessing on the card against the same code on the CPU."""
    import torch

    from eitx_torch.image import (
        body_mask_from_hu,
        minmax_normalize_u8,
        window_normalize,
    )
    from torch_series_phantom import thorax_hu

    rng = np.random.default_rng(11)
    hu = thorax_hu(rng, 512) + rng.normal(0, 12.0, (512, 512)).astype(
        np.float32)
    hu[480:486, 60:450] = 200.0  # a CT-table strip, which the mask drops
    cpu = torch.device("cpu")
    checks = {
        "body_mask": lambda d: body_mask_from_hu(hu, device=d),
        "body_mask_flipud": lambda d: body_mask_from_hu(hu, flipud=True,
                                                        device=d),
        "window_normalize": lambda d: window_normalize(hu, device=d),
        # whole-numbered HU, as a scanner stores them: the exact quotient
        # is an integer on every 80th value, where a rounding shows
        "window_normalize_int16": lambda d: window_normalize(
            np.rint(hu).astype(np.int16), device=d),
        "minmax_normalize_u8": lambda d: minmax_normalize_u8(hu, device=d),
        "minmax_normalize_u8_int16": lambda d: minmax_normalize_u8(
            np.rint(hu).astype(np.int16), device=d),
    }
    for name, fn in checks.items():
        on_card = fn(dev)
        check(on_card.device.type == "cuda", f"{name} did not run on the card")
        check(torch.equal(on_card.cpu(), fn(cpu)),
              f"{name}: the card and the CPU differ")
    mask, steps = count_fixpoint_steps(lambda: checks["body_mask"](dev))
    check(len(steps) == 2, f"body mask ran {len(steps)} fixpoint loops")
    body_px = int((mask > 0).sum().item())
    check(0.25 < body_px / mask.numel() < 0.45 and not bool(mask[483, 200]),
          f"body mask holds {body_px} pixels")
    hu_dev = torch.as_tensor(hu, device=dev)
    emit("image", equal_to_cpu=sorted(checks), body_pixels=body_px,
         labelling_steps=steps[0], flood_steps=steps[1],
         body_mask_ms=cuda_ms(lambda: body_mask_from_hu(hu_dev), reps=5,
                              warmup=1),
         window_normalize_ms=cuda_ms(lambda: window_normalize(hu_dev)),
         minmax_normalize_ms=cuda_ms(lambda: minmax_normalize_u8(hu_dev)))


def phase_ribs(dev, front, fixture):
    """The trained rib detector on the series' frontal view against the
    JAX package's boxes and slice pick, at the serving dtype and in
    float32; both run float32 arithmetic with TF32 off."""
    from eitx_torch.core.config import ModelConfig
    from eitx_torch.models.yolo.infer import RibsDetector
    from eitx_torch.select import select_axial_slice_number

    m = ModelConfig()
    results = {}
    for name, dtype in (("serving", m.dtype), ("f32", "float32")):
        det = RibsDetector(
            weights=os.path.join(WEIGHTS, "ribs_n_640.msgpack"),
            conf=m.ribs_conf, max_det=m.max_detections, dtype=dtype,
            device=dev)
        got, flags = tf32_flags_of(det._float32_network(),
                                   lambda: det.predict(front))
        check(flags and not any(a or b for a, b in flags),
              f"the detector ran with TF32 settings {flags}")
        want_boxes, want_valid = fixture[f"boxes_{name}"], fixture[f"valid_{name}"]
        check(int(got.valid.sum()) == int(want_valid.sum()),
              f"{name}: {int(got.valid.sum())} boxes, the reference has "
              f"{int(want_valid.sum())}")
        check(np.array_equal(got.valid, want_valid), f"{name}: valid slots")
        err = float(np.abs(got.boxes - want_boxes).max())
        check(err <= 0.5, f"{name}: boxes off by {err} px")
        pick = select_axial_slice_number(got.boxes[got.valid], 0,
                                         image_width=front.shape[1])
        check(pick == fixture[f"pick_{name}"].tolist(),
              f"{name}: pick {pick}")
        results[name] = dict(
            dtype=dtype, valid=int(got.valid.sum()), max_box_err_px=err,
            pick=pick, predict_ms=cuda_ms(lambda: det.predict(front), reps=5,
                                          warmup=1))
    emit("ribs", **results)


def _zip_bytes(name: str, data: bytes) -> io.BytesIO:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(name, data)
    return buf


def _check_dat(answer, what: str) -> np.ndarray:
    check(answer["status"] == "success", f"{what}: request failed")
    v = np.loadtxt(answer["saved_file_name"])
    check(v.shape == (1200, 208) and np.isfinite(v).all(),
          f"{what}: .dat {v.shape}")
    return v


def phase_series(dev, vol, fixture, image_512):
    """The series mode at full width, then one request of each other
    container mode. Returns the kernel launches of the counted requests,
    the kernel's inputs in the first series request and the series zip."""
    import torch

    from eitx_torch.core.config import ModelConfig, PipelineConfig
    from eitx_torch.core.timing import Timer
    from eitx_torch.io import to_png_bytes, write_dicom, write_nifti
    from eitx_torch.mesh import pip
    from eitx_torch.pipeline import Pipeline
    from torch_series_phantom import series_volume, series_zip

    t0 = time.perf_counter()
    series = series_zip(vol, write_dicom)
    zip_s = time.perf_counter() - t0
    picked = []  # (instance number, body image, body mask) of each request

    with tempfile.TemporaryDirectory() as results:
        pipe = Pipeline(PipelineConfig(
            model=ModelConfig(
                ribs_weights=os.path.join(WEIGHTS, "ribs_n_640.msgpack"),
                axial_weights_512=os.path.join(WEIGHTS, "tissue_n_512.msgpack"),
                axial_weights_256=os.path.join(WEIGHTS, "tissue_n_256.msgpack"),
            ),
            results_dir=results,
        ), device=dev)
        preprocess = pipe._axial_from_dicom_slice

        def record(ds):
            body, mask, spacing = preprocess(ds)
            picked.append((ds.instance_number, body, mask))
            return body, mask, spacing

        pipe._axial_from_dicom_slice = record
        torch.cuda.reset_peak_memory_stats()
        with recorded_pip_inputs() as recorded:
            pip.pip_launches = 0
            answers, spans, walls = [], [], []
            for _ in range(3):
                timer = Timer()
                t0 = time.perf_counter()
                answers.append(pipe.run_dicom_sequences_auto(series,
                                                             timer=timer))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                spans.append(timer.as_dict())
            launches = pip.pip_launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(launches == 3,
              f"pip kernel launched {launches} times in 3 series requests")
        dats = [open(a["saved_file_name"], "rb").read() for a in answers]
        _check_dat(answers[0], "series")
        check(dats[0] == dats[1] == dats[2],
              ".dat files differ between series requests")
        want_number = int(fixture["slice_index"]) + 1
        for number, body, mask in picked:
            check(number == want_number,
                  f"picked slice {number}, the reference picks {want_number}")
            check(np.array_equal(mask, fixture["body_mask"]),
                  "body mask differs from the reference's")
            check(np.array_equal(body, fixture["body_image"]),
                  "windowed body image differs from the reference's")
        classes = sorted({ln.split()[0] for ln in answers[0]["text_data"][2:]})
        check(len(classes) >= 2, f"classes {classes}")
        for sp, wall in zip(spans, walls):
            check(abs(sum(sp.values()) - wall) < 0.05 * wall,
                  f"spans {sp} do not add up to the wall time {wall}")
        emit("series", slices=int(vol.shape[0]), pixel_bytes=int(vol.nbytes),
             zip_bytes=series.getbuffer().nbytes, zip_s=zip_s,
             request_s=walls, spans_req2=spans[1], spans_req3=spans[2],
             picked_slice=want_number, body_mask_equal=True,
             body_image_equal=True, classes=classes, pip_launches=launches,
             dat_rows=1200, dat_cols=208, dat_bytes_equal=True,
             max_memory_gib=peak_gib)
        emit("profile_series", **profiled_request(
            lambda: pipe.run_dicom_sequences_auto(series)))

        # the other container modes, one request each
        t0 = time.perf_counter()
        pip.pip_launches = 0
        del picked[:]
        timers = {name: Timer() for name in ("custom", "frame", "nii", "zip")}
        _check_dat(pipe.run_dicom_sequences_custom(
            series_zip(vol, write_dicom, custom_offset=1),
            timer=timers["custom"]), "custom")
        check(picked[-1][0] == want_number + 1,
              f"offset 1 picked slice {picked[-1][0]}")
        _check_dat(pipe.run_dicom_frame(
            series_zip(vol[200:203], write_dicom), timer=timers["frame"]),
            "frame")
        check(picked[-1][0] == 3, "the frame mode takes the last slice read")
        small = series_volume(3, 64, 256)  # (64, 256, 256) -> (256, 256, 64)
        nii = np.ascontiguousarray(small.transpose(2, 1, 0)) - 1024
        _check_dat(pipe.run_nii(_zip_bytes("scan.nii.gz", write_nifti(
            nii.astype(np.int16), pixdim=(1.0, 1.4, 1.4, 5.0))),
            timer=timers["nii"]), "nii")
        _check_dat(pipe.run_jpg_png_zip(
            _zip_bytes("slice.png", to_png_bytes(image_512)),
            timer=timers["zip"]), "zip")
        torch.cuda.synchronize()
        check(pip.pip_launches == 4,
              f"pip kernel launched {pip.pip_launches} times in 4 requests")
        emit("modes", s=time.perf_counter() - t0,
             spans={k: t.as_dict() for k, t in timers.items()},
             pip_launches=pip.pip_launches)
        return launches + pip.pip_launches, recorded[0], series


# the synthetic thorax of bench.py build_thorax_mesh (copied: bench.py
# imports the JAX package): eight subjects at lc 7 and one at lc 5, each
# ellipse's radii scaled by 1 +- 3 % from its seed
FACTORY_SUBJECTS = [(seed, 7.0) for seed in range(8)] + [(8, 5.0)]
FACTORY_JITTER = 0.03


def thorax_polygons(seed: int) -> list:
    rng = np.random.default_rng(seed)

    def j():
        return 1.0 + rng.uniform(-FACTORY_JITTER, FACTORY_JITTER)

    def ellipse(cid, cx, cy, rx, ry, n):
        th = np.linspace(0, 2 * np.pi, n, endpoint=False)
        pts = np.stack(
            [cx + rx * j() * np.cos(th), cy + ry * j() * np.sin(th)], 1)
        return f"{cid} " + " ".join(f"{x:.1f} {y:.1f}" for x, y in pts)

    return [
        ellipse(4, 256, 256, 200, 150, 90),
        ellipse(3, 256, 256, 192, 142, 70),
        ellipse(1, 256, 256, 170, 125, 70),
        ellipse(2, 175, 250, 55, 75, 40),
        ellipse(2, 337, 250, 55, 75, 40),
        ellipse(0, 256, 330, 22, 18, 24),
    ]


@contextlib.contextmanager
def stage_timer(targets):
    """While open, every call of ``getattr(owner, name)`` for (owner, name)
    in ``targets`` adds its seconds, up to a device synchronisation, to
    ``times["<owner>.<name>"]`` (owner: the class or the module's last
    name); yields ``times``."""
    import torch

    times = collections.defaultdict(float)
    # the attribute as stored (a classmethod stays a classmethod) and as
    # called
    saved = [(owner, name, vars(owner)[name], getattr(owner, name))
             for owner, name in targets]

    def wrap(key, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[key] += time.perf_counter() - t0
            return out
        return timed

    for owner, name, _, fn in saved:
        key = f"{owner.__name__.rsplit('.', 1)[-1]}.{name}"
        setattr(owner, name, wrap(key, fn))
    try:
        yield times
    finally:
        for owner, name, raw, _ in saved:
            setattr(owner, name, raw)


def oracle_frames(mesh, cfg, frames) -> np.ndarray:
    """The float64 scipy oracle on ``frames`` of a subject's monitoring,
    with the port's own schedule and electrodes: (len(frames), 208)."""
    from eitx_torch.core.config import ClassMap
    from eitx_torch.fem import forward
    from eitx_torch.fem.oracle import monitoring_oracle

    info = forward.compact_mesh_nodes(forward.prepare_mesh_info(mesh))
    sigma, _, proto = forward._schedule(cfg, ClassMap(), None, False)
    el = forward._electrodes(cfg, info)
    return monitoring_oracle(info.node, info.element,
                             sigma[frames][:, info.cond], el, proto.ex_mat,
                             proto.meas_mat).reshape(len(frames), -1)


def oracle_errors(v, ref) -> dict:
    """The fem phase's measures of ``v`` against the float64 oracle's
    ``ref`` (same frames): rows, sums and abs-max, relative."""
    rows = np.abs(v - ref) / np.abs(ref)
    return dict(rows_rel=float(rows.max()),
                sum_rel=float(np.abs(v.sum() - ref.sum()) / abs(ref.sum())),
                absmax_rel=float(abs(np.abs(v).max() - np.abs(ref).max())
                                 / np.abs(ref).max()))


def subject_system(mesh, cfg, dev):
    """A subject's compacted mesh, (T, C) conductivities, protocol,
    electrode nodes and class stiffness, as simulate_eit_monitoring builds
    them."""
    from eitx_torch.core.config import ClassMap
    from eitx_torch.fem import ClassStiffness, forward

    classes = ClassMap()
    info = forward.compact_mesh_nodes(forward.prepare_mesh_info(mesh, classes))
    sigma, _, proto = forward._schedule(cfg, classes, None, False)
    cs = ClassStiffness.build(info.node, info.element, info.cond,
                              n_classes=classes.n_tissues,
                              dtype=forward._dtype(cfg),
                              pad_nodes_to=cfg.pad_nodes_to,
                              pad_elems_to=cfg.pad_elems_to, device=dev)
    return info, sigma, proto, forward._electrodes(cfg, info), cs


def phase_factory(dev):
    """The dataset factory at the serving simulation defaults. Returns the
    kernel launches of its meshing and the kernel's inputs of subject 0."""
    from dataclasses import replace

    import torch

    import eitx_torch.fem.forward as forward
    import eitx_torch.pipeline.batch as batch
    from eitx_torch.core.config import SimulationConfig
    from eitx_torch.fem import (
        ClassStiffness,
        LowRankSpectralSolver,
        forward_solve_batched,
    )
    from eitx_torch.mesh import create_mesh, pip

    cfg = SimulationConfig()
    subjects, mesh_s = [], []
    with recorded_pip_inputs() as recorded:
        pip.pip_launches = 0
        for seed, lc in FACTORY_SUBJECTS:
            t0 = time.perf_counter()
            _, mesh = create_mesh(["0.75", "0.75"], thorax_polygons(seed),
                                  lc=lc, show_meshing_result_method="no",
                                  device=dev)
            torch.cuda.synchronize()
            mesh_s.append(time.perf_counter() - t0)
            subjects.append((f"thorax{seed}_lc{lc:g}", mesh))
        launches = pip.pip_launches
    check(launches == len(subjects),
          f"pip kernel launched {launches} times for {len(subjects)} meshes")
    nodes = [int(np.asarray(m["NODES"]).shape[0]) for _, m in subjects]
    buckets = sorted({-(-n // cfg.pad_nodes_to) * cfg.pad_nodes_to
                      for n in nodes})
    check(len(buckets) == 2, f"node buckets {buckets}")

    stages = [(batch, "simulate_eit_monitoring_subjects"),
              (batch, "write_dat"), (batch, "_save_manifest"),
              (ClassStiffness, "build"), (LowRankSpectralSolver, "build_batch"),
              (forward, "lowrank_solve_batch")]
    runs = []
    with tempfile.TemporaryDirectory() as root:
        for k in range(2):
            out = os.path.join(root, f"run{k}")
            torch.cuda.reset_peak_memory_stats()
            with stage_timer(stages) as times:
                t0 = time.perf_counter()
                man = batch.generate_batch(subjects, out, cfg, device=dev)
                wall = time.perf_counter() - t0
            runs.append(dict(wall_s=wall, stages_s=dict(times),
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                             manifest=man, out=out))
        profile = profiled_request(lambda: batch.generate_batch(
            subjects, os.path.join(root, "profiled"), cfg, device=dev))
        for sid, _ in subjects:
            entries = [r["manifest"]["subjects"][sid] for r in runs]
            check(all(e["status"] == "done" and e.get("batched") is True
                      for e in entries), f"{sid}: {entries}")
            dats = [open(os.path.join(r["out"], f"results_{sid}.dat"),
                         "rb").read() for r in runs]
            check(dats[0] == dats[1], f"{sid}: .dat differs between runs")
        # one breathing cycle of each subject (the file repeats it 12 times)
        volts = {sid: np.loadtxt(os.path.join(runs[1]["out"],
                                              f"results_{sid}.dat"))
                 for sid, _ in subjects}

    # each subject against the float64 oracle on frames 0 and 50, against
    # its own single-subject run, and the float64 route at full width
    worst = collections.defaultdict(float)
    for sid, mesh in subjects:
        v = volts[sid]
        check(v.shape == (1200, 208) and np.isfinite(v).all(),
              f"{sid}: .dat {v.shape}")
        check(np.array_equal(v[:100], v[1100:]), f"{sid}: cycles differ")
        oracle = oracle_frames(mesh, cfg, [0, 50])
        for key, err in oracle_errors(v[[0, 50]], oracle).items():
            worst[key] = max(worst[key], err)
        single, _ = forward.simulate_eit_monitoring(mesh, cfg, device=dev)
        gap = np.abs(v[:100] - single) / (1e-7 + 2e-4 * np.abs(single))
        f64, _ = forward.simulate_eit_monitoring(
            mesh, replace(cfg, precision="f64"), device=dev)
        _, sigma, proto, el, cs = subject_system(mesh, cfg, dev)
        direct = forward_solve_batched(cs, sigma[[0, 50]], el, proto.ex_mat,
                                       proto.meas_mat).reshape(2, -1)
        for key, err in (
                ("batched_vs_single_allclose_err", gap.max()),
                ("f64_oracle_rel_to_max",
                 np.abs(f64[[0, 50]] - oracle).max() / np.abs(oracle).max()),
                ("direct_f32_absmax_rel", oracle_errors(
                    direct.cpu().numpy(), oracle)["absmax_rel"])):
            worst[key] = max(worst[key], float(err))
    # the fem phase's bounds on rows and sums; abs-max is bounded at 5e-3:
    # on one lc-7 subject the largest voltage of every float32 solve, the
    # direct one with its refinement step included, is 2.0-3.6e-3 from
    # float64 (the float64 route is held to F64_BOUND of scale)
    check(worst["rows_rel"] < 2e-2, f"oracle rows off: {dict(worst)}")
    check(worst["sum_rel"] < 2e-3 and worst["absmax_rel"] < 5e-3,
          f"oracle sum / abs-max off: {dict(worst)}")
    check(worst["f64_oracle_rel_to_max"] < F64_BOUND,
          f"float64 route off the oracle: {dict(worst)}")
    check(worst["batched_vs_single_allclose_err"] <= 1.0,
          f"batched differs from single: {dict(worst)}")
    second = runs[1]
    emit("factory", subjects=len(subjects), nodes=nodes, buckets=buckets,
         mesh_s=mesh_s, pip_launches=launches,
         run_s=[r["wall_s"] for r in runs],
         stages_s=[r["stages_s"] for r in runs],
         peak_gib=[r["peak_gib"] for r in runs],
         subjects_per_hour=len(subjects) / second["wall_s"] * 3600.0,
         dat_rows=1200, dat_cols=208, dat_bytes_equal=True, batched=True,
         oracle_frames=[0, 50], **dict(worst))
    emit("profile_factory", **profile)
    return launches, recorded[0]


def _time_call(fn):
    """(result, seconds) of ``fn()`` up to a device synchronisation."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_solvers(dev, mesh):
    """Every solver family once on the mesh phase's mesh, 8 frames: each
    against the float64 oracle, the goldens or its sibling, timed twice
    (first call, then warm)."""
    from dataclasses import replace

    import eitx_torch.fem.forward as forward
    from eitx_torch.core.config import SimulationConfig
    from eitx_torch.fem import (
        ClassStiffness,
        LowRankSpectralSolver,
        SpectralEITSolver,
        forward_solve,
        forward_solve_admittance,
        sheffield_monitoring,
        simulate_eit_monitoring,
        simulate_eit_spectroscopy,
    )
    from eitx_torch.fem.solver import forward_solve_cg_info

    cfg = SimulationConfig(n_points=8, n_spir=1, n_minutes=1)
    oracle = oracle_frames(mesh, cfg, list(range(8)))
    results, times = {}, {}
    # each family's own device work inside simulate_eit_monitoring: the
    # assembly, the setup and the solve, apart from the host's mesh work
    stages = [(ClassStiffness, "build"), (forward, "forward_solve_batched"),
              (forward, "forward_solve_cg"), (forward, "forward_solve_cem"),
              (forward, "spectral_cem_solver"),
              (SpectralEITSolver, "build"), (SpectralEITSolver, "solve"),
              (LowRankSpectralSolver, "build"),
              (LowRankSpectralSolver, "solve")]

    def run(name, fn):
        fn()  # first call: workspaces, first shapes
        with stage_timer(stages) as staged:
            out, wall = _time_call(fn)
        times[name] = dict(call_s=wall, **staged)
        return out

    def simulate(**kw):
        return lambda: simulate_eit_monitoring(
            mesh, replace(cfg, **kw), device=dev)[0]

    for name, kw, bound in [
            ("cholesky", dict(solver="cholesky"), 2e-2),
            ("spectral_full", dict(solver="spectral_full"), 2e-2),
            ("spectral", dict(solver="spectral"), 2e-2),
            ("f64_spectral", dict(solver="spectral", precision="f64"),
             F64_BOUND),
            ("f64_cholesky", dict(solver="cholesky", precision="f64"),
             F64_BOUND)]:
        v = run(name, simulate(**kw))
        check(v.shape == (8, 208) and np.isfinite(v).all(), f"{name} {v.shape}")
        gold = dict(
            row0=float((np.abs(v[0][:6] - GOLD_ROW0) / GOLD_ROW0).max()),
            row5=float((np.abs(v[5][-6:] - GOLD_ROW5) / GOLD_ROW5).max()),
            sum=float(abs(v.sum() - GOLD_SUM) / GOLD_SUM),
            absmax=float(abs(np.abs(v).max() - GOLD_ABSMAX) / GOLD_ABSMAX))
        rel = float(np.abs(v - oracle).max() / np.abs(oracle).max())
        results[name] = dict(gold_rel=gold, oracle_rel_to_max=rel)
        if bound == 2e-2:  # the fem phase's float32 bounds
            check(max(gold["row0"], gold["row5"]) < 2e-2, f"{name} rows off")
            check(max(gold["sum"], gold["absmax"]) < 2e-3,
                  f"{name} sum / abs-max off")
        else:  # float64: the oracle to F64_BOUND of scale, the goldens to
            # the digits they were written with
            check(rel < bound, f"{name}: {rel} from the oracle")
            check(max(gold.values()) < 1e-6, f"{name} goldens off: {gold}")
        if name == "cholesky":
            direct = v

    # CG: the reference's test settings against the direct solve, then at
    # its defaults on the same system
    info, sigma, proto, el, cs = subject_system(mesh, cfg, dev)
    for name, kw in (("cg_tight", dict(tol=1e-9, maxiter=3000)),
                     ("cg_default", {})):
        v, iters, res = run(name, lambda: forward_solve_cg_info(
            cs, sigma, el, proto.ex_mat, proto.meas_mat, **kw))
        v = v.reshape(8, -1).cpu().numpy()
        rel = float(np.abs(v - direct).max() / np.abs(direct).max())
        results[name] = dict(iterations=iters.tolist(),
                             rel_residual=res.tolist(), vs_direct_rel=rel,
                             oracle_rel_to_max=float(
                                 np.abs(v - oracle).max() / np.abs(oracle).max()))
        check(np.isfinite(v).all(), f"{name} not finite")
        if name == "cg_tight":
            check(rel < 5e-3, f"CG vs direct {rel}")

    # CEM: direct against spectral. Float32 is measured, not bounded: on
    # this mesh the augmented system's float32 solves of both packages sit
    # 10-15 % of scale from float64 (the reference's own bound of 3e-3,
    # tests/test_cem.py:128, holds on its small disk); float64 is held to it
    cem = {(s, p): run(f"cem_{s}_{p}", simulate(
        solver=s, electrode_model="cem", precision=p))
        for s in ("cholesky", "spectral") for p in ("f32", "f64")}
    truth = cem["cholesky", "f64"]

    def cem_rel(key, ref=truth):
        return float(np.abs(cem[key] - ref).max() / np.abs(ref).max())

    rel = cem_rel(("spectral", "f64"))
    check(all(np.isfinite(v).all() for v in cem.values()) and rel < 3e-3,
          f"CEM spectral vs direct {rel}")
    results["cem"] = dict(
        f64_spectral_vs_direct_rel=rel,
        f32_spectral_vs_direct_rel=cem_rel(("spectral", "f32"),
                                           cem["cholesky", "f32"]),
        f32_direct_vs_f64_rel=cem_rel(("cholesky", "f32")),
        f32_spectral_vs_f64_rel=cem_rel(("spectral", "f32")))

    # the FEMM path: admittance with eps_r = 0 against the real solver
    cond = sigma[0][info.cond]
    args = (el, proto.ex_mat, proto.meas_mat, info.node.shape[0])
    vc = run("admittance", lambda: forward_solve_admittance(
        info.node, info.element, cond, np.zeros_like(cond), 5e4, *args,
        device=dev)).cpu().numpy()
    vr = forward_solve(info.node, info.element, cond, *args,
                       device=dev).cpu().numpy()
    rel = float(np.abs(vc.real - vr).max() / np.abs(vr).max())
    check(np.abs(vc.imag).max() < 1e-5 * np.abs(vr).max() and rel < 1e-3,
          f"admittance vs real solver {rel}")
    results["admittance"] = dict(vs_real_rel=rel,
                                 imag_max=float(np.abs(vc.imag).max()))
    sweep = run("spectroscopy", lambda: simulate_eit_spectroscopy(
        mesh, [1e4, 5e4, 2e5, 1e6], device=dev))
    check(sweep.shape == (4, 16, 13) and np.isfinite(sweep).all()
          and np.abs(np.abs(sweep[0]) - np.abs(sweep[2])).max() > 0
          and np.abs(sweep.imag).max() > 0, "spectroscopy sweep")
    # flat electrodes of 6 mesh units across, centred on the electrode
    # nodes, along the boundary's tangent; lungs follow the schedule
    centre = info.node.mean(axis=0)
    th = np.arctan2(*(info.node[el] - centre).T[::-1])
    tang = np.stack([-np.sin(th), np.cos(th)], 1) * 3.0
    elecs = np.stack([np.stack([info.node[e] - t, info.node[e] + t,
                                info.node[e]]) for e, t in zip(el, tang)])
    sig_t = sigma[:, info.cond]
    shef = run("sheffield", lambda: sheffield_monitoring(
        info.node, info.element, sig_t, np.zeros_like(sig_t), 5e4, elecs,
        device=dev))
    scale = np.abs(shef).max()
    check(shef.shape == (8, 16, 16) and np.isfinite(shef).all(), "sheffield")
    check(np.abs(shef - shef[:1]).max() > 1e-6 * scale,
          "sheffield: breathing does not modulate")
    check(np.abs(shef.sum(axis=-1)).max() < 1e-5 * scale,
          "sheffield: rows do not telescope")
    results["sheffield"] = dict(
        modulation_rel=float(np.abs(shef - shef[:1]).max() / scale))
    emit("solvers", frames=8, nodes=int(info.node.shape[0]),
         padded_nodes=cs.n_nodes, warm_s=times, **results)


# the inverse phase's bounds, scale-relative: float32 against float64 on
# the card, or the card against the same float32 code on the CPU; each
# about 4 times what the H100 measured (PERF.md). On the lc-7 slice the
# card's float32 field solves leave the Jacobian 2.5e-3 of scale from
# float64 (the CPU's 1.9e-4), and the regularized measurement-space solve
# carries any Jacobian error into the images: 2.2e-2,
# and 1.0e-2 with float64 fields and float32 element sums
# (tests/torch_inverse_precision.py). GREIT's train solve does the same to
# R (card vs CPU 7.4e-3). Gauss-Newton's eight regularized steps fit the
# data alike on both (squared residual 3.3e-6 vs 3.0e-6 of 0.12) and
# differ by 1.7e-2 in what the data barely sees
INV_JAC_F64 = 1e-2
INV_IMAGES_F64 = 1e-1
GREIT_R_CPU = 3e-2
GN_SIGMA_CPU = 1e-1
GN_ITERATIONS = 8


@contextlib.contextmanager
def device_waits():
    """While open, torch's sync debug mode warns on every operation that
    makes the host wait for the device; yields a list that gets, as they
    come, "file:line" of the line that waited and of the package's line
    under which it ran. Nests: an inner block keeps its own waits."""
    import traceback
    import warnings

    import torch

    package = os.path.join(ROOT, "eitx_torch")

    class Waits(list):  # catch_warnings' record list: note the caller
        armed = False  # switching the mode on and off is no wait

        def append(self, w):
            if self.armed and "synchroniz" in str(w.message):
                stack = traceback.extract_stack()[:-2]
                sites = [f for f in stack if f.filename.startswith(package)]
                # the package's line, and the library line under it
                where = sites[-1:] + stack[-1:]
                super().append(" <- ".join(
                    f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
                    for f in where[::-1]))

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        waits = Waits()
        warnings._showwarnmsg_impl = waits.append
        torch.cuda.set_sync_debug_mode("warn")
        waits.armed = True
        try:
            yield waits
        finally:
            waits.armed = False
            torch.cuda.set_sync_debug_mode(prev)


def _rel_to_max(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def phase_inverse(dev):
    """Inverse imaging at full width on the real slice meshed at the
    serving lc 7: difference imaging and GREIT of the serving monitoring
    (1200 frames of 208), Gauss-Newton of an inclusion; each against
    float64 on the card or the same code on the CPU. Returns the kernel
    launches of the meshing."""
    import torch

    import eitx_torch.fem.forward as forward
    import eitx_torch.fem.greit as greit_module
    import eitx_torch.fem.inverse as inverse
    from eitx_torch.core.config import ClassMap, SimulationConfig
    from eitx_torch.fem import (
        DifferenceImager,
        GreitImager,
        gauss_newton_absolute,
        greit_monitoring,
        reconstruct_monitoring,
        simulate_eit_monitoring,
    )
    from eitx_torch.fem.oracle import forward_solve_oracle
    from eitx_torch.mesh import create_mesh, pip

    cpu = torch.device("cpu")
    failed = []

    def expect(cond: bool, what: str) -> None:
        # the checks after the meshing note their failure and go on, so the
        # phase prints every number before it fails
        if not cond:
            failed.append(what)

    pip.pip_launches = 0
    _, mesh = create_mesh(["1", "1"], real_polygons(), 7, 1.3, 1,
                          show_meshing_result_method="no", device=dev)
    launches = pip.pip_launches
    check(launches == 1, f"create_mesh launched the kernel {launches} times")
    cfg = SimulationConfig()
    v, _ = simulate_eit_monitoring(mesh, cfg, device=dev)
    # the serving .dat: the breathing cycle once per breath
    frames = np.tile(v, (cfg.n_spir * cfg.n_minutes, 1))
    expect(frames.shape == (1200, 208), f"monitoring {frames.shape}")
    info, sigma_ref, el, proto = inverse.monitoring_linearization(mesh)
    nodes, tris = info.node, info.element
    lung = info.cond == 2
    cent = nodes[tris].mean(axis=1)
    times = {}

    # difference imaging: the whole monitoring, then the same in float64
    ds, imager = reconstruct_monitoring(mesh, frames, device=dev)
    expect(ds.shape == (1200, tris.shape[0]) and np.isfinite(ds).all(),
           f"difference images {ds.shape}")
    build = (nodes, tris, sigma_ref, el, proto.ex_mat, proto.meas_mat)
    imager, times["difference_build_s"] = _time_call(
        lambda: DifferenceImager.build(*build, device=dev))
    vt = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    dv = vt - vt[0][None]
    times["difference_1200_frames_ms"] = cuda_ms(
        lambda: imager.reconstruct(dv))
    f64 = torch.float64
    ix = [torch.as_tensor(np.asarray(a), device=dev)
          for a in (tris, el, proto.ex_mat, proto.meas_mat)]
    jac64 = inverse._difference_jacobian(
        torch.as_tensor(nodes, dtype=f64, device=dev), ix[0],
        torch.as_tensor(sigma_ref, dtype=f64, device=dev), *ix[1:],
        nodes.shape[0])
    chol64, info64 = inverse._factor(jac64, 1e-3)
    expect(int(info64) == 0, "float64 factorization failed")
    ds64 = inverse._reconstruct(jac64, chol64, dv.to(f64)).cpu().numpy()
    jac_rel = _rel_to_max(imager.jac.cpu().numpy(), jac64.cpu().numpy())
    img_rel = _rel_to_max(ds, ds64)
    expect(jac_rel < INV_JAC_F64, f"Jacobian {jac_rel} from float64")
    expect(img_rel < INV_IMAGES_F64,
           f"difference images {img_rel} from float64")
    # the lungs' mean change follows their conductivity schedule. The
    # per-element variance check of tests/test_inverse.py does not hold on
    # this slice, in float64 either: bone and fat elements vary more than
    # lung ones (the uniform Tikhonov weight lets the low-conductivity
    # tissues take the change); GREIT's equal-area targets do not
    var = ds.var(axis=0)
    sigma_t, lung_col, _ = forward._schedule(cfg, ClassMap(), None, False)
    schedule = np.tile(sigma_t[:, lung_col], cfg.n_spir * cfg.n_minutes)
    lung_corr = float(np.corrcoef(ds[:, lung].mean(axis=1), schedule)[0, 1])
    expect(lung_corr > 0.95,
           f"difference images: the lungs' change follows the schedule at "
           f"{lung_corr}")

    # GREIT at its defaults (npx 32, pads 1024 / 8192)
    images, greit = greit_monitoring(mesh, frames, device=dev)
    expect(images.shape == (1200, 32, 32) and np.isfinite(images).all(),
           f"GREIT images {images.shape}")
    greit, times["greit_build_s"] = _time_call(
        lambda: GreitImager.build(*build, device=dev))
    mask_dev = torch.as_tensor(greit.mask, device=dev).to(greit.R.dtype)
    times["greit_1200_frames_ms"] = cuda_ms(
        lambda: greit_module._apply(greit.R, mask_dev, dv))
    t0 = time.perf_counter()
    on_cpu = GreitImager.build(*build, device=cpu)
    times["greit_build_cpu_s"] = time.perf_counter() - t0
    expect(np.array_equal(greit.mask, on_cpu.mask),
           "GREIT mask: the card and the CPU differ")
    r_rel = _rel_to_max(greit.R.cpu().numpy(), on_cpu.R.numpy())
    expect(r_rel < GREIT_R_CPU, f"GREIT R {r_rel} from the CPU's")
    xmin, xmax, ymin, ymax = greit.extent
    px = np.clip(((cent[:, 0] - xmin) / (xmax - xmin) * 32).astype(int), 0, 31)
    py = np.clip(((cent[:, 1] - ymin) / (ymax - ymin) * 32).astype(int), 0, 31)
    lung_px = np.zeros((32, 32), bool)
    lung_px[py[lung], px[lung]] = True
    pvar = images.var(axis=0)
    expect(pvar[lung_px].mean() > pvar[greit.mask & ~lung_px].mean(),
           "GREIT: the lung pixels do not modulate most")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "greit.npz")
        greit.save(path)
        again = GreitImager.load(path, device=dev)
        expect(np.array_equal(again.reconstruct(frames[:50] - frames[0]),
                              greit.reconstruct(frames[:50] - frames[0])),
               "GREIT: a save / load round trip images differently")

    # Gauss-Newton: +50 % in the left lung of a body at the lung's
    # conductivity (from the homogeneous start, a tissue-table background
    # does not fit: its residual grows)
    left = lung & (cent[:, 0] < np.median(cent[lung, 0]))
    sigma_true = np.full(tris.shape[0], sigma_ref[lung][0])
    sigma_true[left] *= 1.5
    v_meas = forward_solve_oracle(nodes, tris, sigma_true, el, proto.ex_mat,
                                  proto.meas_mat)
    gn = (nodes, tris, v_meas, el, proto.ex_mat, proto.meas_mat)
    gauss_newton_absolute(*gn, n_iter=GN_ITERATIONS, device=dev)
    loop, loop_waits, loop_ms = inverse._gauss_newton, [], []

    def observed(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with device_waits() as waits:
            a.record()
            out = loop(*args, **kw)
            b.record()
        loop_waits.extend(waits)
        loop_ms.append((a, b))
        return out

    inverse._gauss_newton = observed
    try:
        with device_waits() as call_waits:
            t0 = time.perf_counter()
            sigma, res = gauss_newton_absolute(*gn, n_iter=GN_ITERATIONS,
                                               device=dev)
            times["gauss_newton_call_s"] = time.perf_counter() - t0
    finally:
        inverse._gauss_newton = loop
    a, b = loop_ms[0]
    times["gauss_newton_per_iteration_ms"] = a.elapsed_time(b) / GN_ITERATIONS
    expect(loop_waits == [], f"the Gauss-Newton loop waited at {loop_waits}")
    t0 = time.perf_counter()
    sigma_cpu, res_cpu = gauss_newton_absolute(*gn, n_iter=GN_ITERATIONS,
                                               device=cpu)
    times["gauss_newton_cpu_s"] = time.perf_counter() - t0
    ratio = float(sigma[left].mean() / sigma[~left].mean())
    expect(res[-1] < 0.2 * res[0], f"Gauss-Newton residuals {res.tolist()}")
    expect(ratio >= 1.25, f"inclusion / rest {ratio}")
    gn_rel = _rel_to_max(sigma, sigma_cpu)
    expect(gn_rel < GN_SIGMA_CPU,
           f"Gauss-Newton sigma {gn_rel} from the CPU's")
    emit("inverse", nodes=int(nodes.shape[0]), elements=int(tris.shape[0]),
         frames=list(frames.shape), pip_launches=launches,
         jacobian_f64_rel_to_max=jac_rel, jacobian_bound=INV_JAC_F64,
         images_f64_rel_to_max=img_rel, images_bound=INV_IMAGES_F64,
         lung_schedule_corr=lung_corr,
         var_by_class={c: float(var[info.cond == c].mean())
                       for c in range(4)},
         greit_mask_equal_cpu=True, greit_mask_pixels=int(greit.mask.sum()),
         greit_R_cpu_rel_to_max=r_rel, greit_R_bound=GREIT_R_CPU,
         greit_lung_var=float(pvar[lung_px].mean()),
         greit_rest_var=float(pvar[greit.mask & ~lung_px].mean()),
         greit_save_load_equal=True,
         gn_residuals=res.tolist(), gn_residuals_cpu=res_cpu.tolist(),
         gn_inclusion_ratio=ratio, gn_sigma_cpu_rel_to_max=gn_rel,
         gn_sigma_bound=GN_SIGMA_CPU, gn_loop_device_waits=len(loop_waits),
         gn_loop_wait_sites=sorted(set(loop_waits)),
         gn_call_device_waits=len(call_waits),
         gn_call_wait_sites=sorted(set(call_waits)),
         difference_images_per_s=1200 / times[
             "difference_1200_frames_ms"] * 1e3,
         greit_images_per_s=1200 / times["greit_1200_frames_ms"] * 1e3,
         warm=times, failed=failed)
    check(not failed, "; ".join(failed))
    return launches


def _multipart(blob: bytes, boundary: str = "chipSmokeBoundary") -> tuple:
    """(body, content type) of a browser form holding ``blob`` as ``file``."""
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"upload.zip\"\r\nContent-Type: application/zip\r\n\r\n"
            ).encode() + blob + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _http(base: str, path: str, body=None, ctype=None) -> tuple:
    """(status, body bytes, seconds) of one request to the service."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=body, method="POST"
                                 if body is not None else "GET",
                                 headers={"Content-Type": ctype} if ctype
                                 else {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def phase_serve(dev, image, series, want_number):
    """The port's HTTP service over the serving pipeline on the card:
    /health, /ui, three sequential and three concurrent image requests
    (byte-equal .dat files, equal to a direct call's), one series request
    through the client, /createMesh and the error routes. Returns the
    kernel launches of the requests."""
    import torch

    from eitx_torch.core.config import ModelConfig, PipelineConfig
    from eitx_torch.io import to_png_bytes
    from eitx_torch.mesh import create_mesh, pip
    from eitx_torch.pipeline import Pipeline
    from eitx_torch.serve import EitxHTTPServer
    from eitx_torch.serve.client import upload, zip_files_in_memory

    zipped = zip_files_in_memory([("slice.png", to_png_bytes(image))])
    body, ctype = _multipart(zipped)
    with tempfile.TemporaryDirectory() as results:
        pipe = Pipeline(PipelineConfig(
            model=ModelConfig(
                ribs_weights=os.path.join(WEIGHTS, "ribs_n_640.msgpack"),
                axial_weights_512=os.path.join(WEIGHTS, "tissue_n_512.msgpack"),
                axial_weights_256=os.path.join(WEIGHTS, "tissue_n_256.msgpack"),
            ),
            results_dir=results,
        ), device=dev)
        picked = []
        preprocess = pipe._axial_from_dicom_slice

        def record(ds):
            picked.append(ds.instance_number)
            return preprocess(ds)

        pipe._axial_from_dicom_slice = record
        inside = []  # seconds each image request spent in the pipeline
        active = [0, 0]  # requests inside the pipeline now, and at most
        count = threading.Lock()
        run_zip = pipe.run_jpg_png_zip

        def timed_zip(body):
            t0 = time.perf_counter()
            with count:
                active[0] += 1
                active[1] = max(active)
            try:
                return run_zip(body)
            finally:
                torch.cuda.synchronize()
                inside.append(time.perf_counter() - t0)
                with count:
                    active[0] -= 1

        pipe.run_jpg_png_zip = timed_zip
        direct, walls = [], []
        for _ in range(2):  # the first call warms the pipeline
            t0 = time.perf_counter()
            direct.append(pipe.run_jpg_png_zip(io.BytesIO(zipped)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        srv = EitxHTTPServer(pipe, host="127.0.0.1", port=0)
        srv.start_background()
        base = f"http://127.0.0.1:{srv.port}"
        try:
            code, health, _ = _http(base, "/health")
            check(code == 200 and json.loads(health)["status"] == "ok",
                  f"/health {code}")
            code, page, _ = _http(base, "/ui")
            check(code == 200 and b"uploadImageAxialSlice" in page,
                  f"/ui {code}")
            pip.pip_launches = 0
            del inside[:]
            sequential = [_http(base, "/uploadImageAxialSlice", body, ctype)
                          for _ in range(3)]
            overhead_ms = [(r[2] - t) * 1e3 for r, t in zip(sequential,
                                                              inside)]
            active[1] = 0
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=3) as pool:
                concurrent = [f.result() for f in [
                    pool.submit(_http, base, "/uploadImageAxialSlice", body,
                                ctype) for _ in range(3)]]
            concurrent_wall_s = time.perf_counter() - t0
            at_once = active[1]
            t0 = time.perf_counter()
            series_answer = upload(base, "dicom_sequences_auto",
                                   series.getvalue())
            series_s = time.perf_counter() - t0
            mesh_body = json.dumps({"params": [1, 1, 7],
                                    "polygons": real_polygons()}).encode()
            code, meshed, mesh_s = _http(base, "/createMesh", mesh_body,
                                         "application/json")
            check(code == 200, f"/createMesh {code}: {meshed[:200]}")
            launches = pip.pip_launches
            bad, _, _ = _http(base, "/uploadImageAxialSlice",
                              *_multipart(b"not a zip"))
            missing, _, _ = _http(base, "/nope", b"", "application/zip")
        finally:
            srv.shutdown()
        check(bad == 400 and missing == 404,
              f"a bad upload gave {bad}, an unknown route {missing}")
        answers = [json.loads(r[1]) for r in sequential + concurrent]
        check(all(r[0] == 200 for r in sequential + concurrent)
              and all(a["status"] == "success" for a in answers),
              "an image request failed")
        dats = [open(a["saved_file_name"], "rb").read()
                for a in direct + answers]
        check(len({a["saved_file_name"] for a in direct + answers}) == 8,
              "two requests wrote one file")
        check(all(d == dats[0] for d in dats),
              ".dat files differ between direct, sequential and concurrent "
              "requests")
        _check_dat(direct[0], "direct")
        check(series_answer["status"] == "success", "series request failed")
        check(picked[-1] == want_number,
              f"the series request picked {picked[-1]}, want {want_number}")
        _check_dat(series_answer, "series over HTTP")
        n_elements = json.loads(meshed)["n_elements"]
        _, ref_mesh = create_mesh(["1", "1"], real_polygons(), lc=7.0,
                                  show_meshing_result_method="no", device=dev)
        check(n_elements == len(ref_mesh["TRIANGLES"]),
              f"/createMesh gave {n_elements} elements")
    check(launches == 8, f"pip kernel launched {launches} times in 7 "
          "pipeline requests and one /createMesh")
    check(at_once >= 2, f"at most {at_once} concurrent request in the "
          "pipeline at once")
    emit("serve", direct_s=walls, sequential_s=[r[2] for r in sequential],
         concurrent_s=[r[2] for r in concurrent],
         # the three concurrent requests from the first sent to the last
         # answered, against three sequential ones; the requests inside the
         # pipeline at once (the service holds no lock)
         concurrent_wall_s=concurrent_wall_s,
         sequential_sum_s=sum(r[2] for r in sequential),
         concurrent_inside_at_once=at_once,
         # a request's wall time less its time inside the pipeline: the
         # upload, the multipart parse, the answer's JSON, the HTTP round
         http_overhead_ms=overhead_ms,
         series_s=series_s, series_body_bytes=series.getbuffer().nbytes,
         picked_slice=picked[-1], create_mesh_s=mesh_s,
         create_mesh_elements=n_elements, dat_bytes_equal=True,
         pip_launches=launches, bad_upload=bad, unknown_route=missing)
    return launches


VARIANT_SHIFTS = [(0, 0), (6, 0), (0, -9), (-5, 4), (11, 7), (-8, -12),
                  (3, 15), (-14, 2)]


def _variant(a, shift: int, flip: int) -> np.ndarray:
    """``a`` flipped (bit 0: rows, bit 1: columns) and rolled by shift
    ``shift`` of VARIANT_SHIFTS."""
    axes = [ax for ax, on in ((0, flip & 1), (1, flip & 2)) if on]
    return np.roll(np.flip(a, axes), VARIANT_SHIFTS[shift], (0, 1))


def phase_eval(dev, image, labels):
    """PixelLevelEvaluator (trained 512 checkpoint, batch 16) over 32
    variants of the phantom slice with YOLO polygon labels traced from the
    fixture's labels: its per-class results against evaluate_dataset of
    the same pairs on the CPU, with the labels the card gave."""
    import torch

    from eitx_torch.contours.formats import to_yolo_label
    from eitx_torch.contours.trace import find_external_contours
    from eitx_torch.eval import (
        PixelLevelEvaluator,
        evaluate_dataset,
        mask_from_yolo_labels,
    )
    from eitx_torch.io import to_png_bytes

    with tempfile.TemporaryDirectory() as root:
        img_dir, lab_dir = (os.path.join(root, d) for d in ("images",
                                                             "labels"))
        os.makedirs(img_dir)
        os.makedirs(lab_dir)
        for k in range(len(VARIANT_SHIFTS)):
            for flip in range(4):
                img = _variant(image, k, flip)
                lab = _variant(labels, k, flip)
                name = f"v{k}_{flip}"
                with open(os.path.join(img_dir, name + ".png"), "wb") as fh:
                    fh.write(to_png_bytes(np.ascontiguousarray(img)))
                lines = [to_yolo_label(cid, c, lab.shape)
                         for cid in range(4)
                         for c in find_external_contours(
                             (lab == cid).astype(np.uint8))
                         if c.shape[0] >= 3]
                with open(os.path.join(lab_dir, name + ".txt"), "w") as fh:
                    fh.write("\n".join(lines))
        ev = PixelLevelEvaluator(
            model_path=os.path.join(WEIGHTS, "tissue_n_512.msgpack"),
            images_dir=img_dir, labels_dir=lab_dir, img_size=512, batch=16,
            device=dev)
        seen = []
        segment = ev.segmenter.segment_labels

        def record(images):
            out = segment(images)
            seen.append((images.shape, out))
            return out

        ev.segmenter.segment_labels = record
        ev.evaluate()  # first run: the segmenter's first shapes
        del seen[:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = ev.evaluate()
        eval_s = time.perf_counter() - t0
        files = sorted(os.listdir(img_dir))
        pred = np.concatenate([out for _, out in seen])
        pairs = [(mask_from_yolo_labels(os.path.join(
            lab_dir, f[:-4] + ".txt"), 512, 512), (p + 1).astype(np.uint8))
            for f, p in zip(files, pred)]
    check([s for s, _ in seen] == [(16, 512, 512)] * 2,
          f"segmenter batches {[s for s, _ in seen]}")
    check(results == evaluate_dataset(pairs),
          "harness results differ from evaluate_dataset of its pairs")
    # a sanity bound on the soft tissues and lungs; thin bone is left out
    # (the harness segments at its defaults, confidence 0.3 at prototype
    # resolution, and marks 3.9 times the labelled bone area: IoU 0.17 on
    # the CPU)
    iou = {c: m["iou"] for c, m in results.items()}
    check(all(iou[c] > 0.5 for c in (1, 2, 3)), f"per-class IoU {iou}")
    emit("eval", images=len(files), batch=16, per_class=results,
         images_per_s=len(files) / eval_s, eval_s=eval_s)


# the train phase: train_tissue's defaults at 512 (the run that made
# weights/tissue_n_512.msgpack) and train_ribs' at 640
TRAIN_SEG = dict(imgsz=512, nc=4, variant="n", mask_topk=160,
                 max_instances=12, proto_stride=4, assigner="tal",
                 warmup_steps=10, total_steps=100)
TRAIN_SEG_BATCH, TRAIN_SEG_STORE, TRAIN_MASK_RES = 8, 32, 256
TRAIN_RIBS = dict(imgsz=640, nc=1, variant="n", segment=False,
                  max_instances=24, warmup_steps=10, total_steps=100)
TRAIN_RIBS_BATCH, TRAIN_RIBS_STORE = 4, 16
# the card's step against the CPU's, same parameters and batch, TF32 off:
# float32 convolutions and sums in other orders (cuDNN vs oneDNN) through
# the network and its backward. The bounds sit between those readings and
# the same step's with TF32 on (the control, read in every run): both are
# written in PERF.md. The loss's bound is 5e-5: an untrained network's
# classification loss is a sum over every anchor and class (21,504 terms
# at 512^2), and on eitx's initial networks the card and the CPU read up
# to 1.27e-5 apart (this phase's seed 1; 7.9e-6 at most over seeds 1-8 in
# tests/torch_card_vs_cpu.py), TF32 at least 1.6e-3
CARD_VS_CPU_LOSS_RTOL = 5e-5
TRAIN_STATS_OF_SCALE = 1e-5
# Two runs on the card from one seed, a resumed run against the one it came
# from, and a (1, 1) mesh against no mesh are held to the bit: every leaf
# of state (``state_digests``). The port's convolutions run cuDNN's
# deterministic algorithms only (``eitx_torch.core.device``).


def _timed_steps(run, steps: int) -> float:
    """ms of one step of ``run()`` (``steps`` steps) between two CUDA
    events."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / steps, out


def state_digests(trainer, ema=None) -> dict:
    """The sha256 of every leaf of ``trainer``'s state (parameters, batch
    statistics, Adam's moments) and of the EMA's parameters, by name."""
    st = trainer.state
    leaves = {**{f"params/{n}": t for n, t in st.params.items()},
              **{f"batch_stats/{n}": t for n, t in st.batch_stats.items()},
              **{f"mu/{n}": t for n, t in st.opt_state.mu.items()},
              **{f"nu/{n}": t for n, t in st.opt_state.nu.items()},
              **{f"ema/{n}": t for n, t in (ema or {}).items()}}
    return {n: hashlib.sha256(t.detach().contiguous().cpu().numpy()
                              .tobytes()).hexdigest()
            for n, t in leaves.items()}


def digests_differ(a: dict, b: dict) -> list:
    """Names whose digests differ (or that only one side holds)."""
    return sorted(n for n in set(a) | set(b) if a.get(n) != b.get(n))


def seeded_run_digests(cfg: dict, store, batch: int, warm: int, steps: int,
                       dev) -> dict:
    """The train phase's run again: ``Trainer(cfg, seed=0)``, ``warm``
    steps and then ``steps`` through ``fit`` from a fresh
    ``device_batches(store, batch, seed=0)``; its ``state_digests``."""
    from eitx_torch.train import TrainConfig, Trainer
    from eitx_torch.train.data import device_batches
    from eitx_torch.train.trainer import fit

    trainer = Trainer(TrainConfig(**cfg), seed=0, device=dev)
    stream = device_batches(store, batch, seed=0, device=dev)
    for _ in range(warm):
        trainer.train_step(next(stream))
    _, ema = fit(trainer, stream, steps, log_every=0)
    return state_digests(trainer, ema)


def step_card_vs_cpu(cfg, batch: dict, seed: int, dev) -> dict:
    """One ``train_step`` of ``Trainer(cfg, seed)`` on ``batch`` on the card
    against the same step on the CPU: the loss components' relative errors
    and the batch statistics' largest error over their scale, TF32 off;
    then the same with TF32 on for the card's step (``tf32_control``; the
    port never runs so)."""
    import torch

    from eitx_torch.train import Trainer

    cpu = Trainer(cfg, seed=seed, device="cpu")
    m_cpu = cpu.train_step({k: v.cpu() for k, v in batch.items()})
    scale = max(float(t.abs().max()) for t in cpu.state.batch_stats.values())

    def against_cpu() -> dict:
        card = Trainer(cfg, seed=seed, device=dev)
        m_card = card.train_step(batch)
        return dict(
            loss_rel={k: abs(m_card[k] - v) / max(abs(v), 1e-30)
                      for k, v in m_cpu.items() if abs(v) > 0},
            batch_stats_of_scale=max(
                float((card.state.batch_stats[n].cpu() - t).abs().max())
                for n, t in cpu.state.batch_stats.items()) / scale)

    out = against_cpu()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        out["tf32_control"] = against_cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return out


def check_prng(dev, trainer) -> None:
    """The seeded draws on the card against tests/data/torch_prng_fixture.npz
    (the JAX package's): the train phase's trainer before its first step
    and the untrained YOLOv11-s segmenter (every leaf's float64 sums and
    first elements), and the first batches of a seeded stream with the
    mosaic (the host's draws, the sha256 of every array). The stream's
    batches after its first (which uploads the store) run under
    ``torch.cuda.set_sync_debug_mode("error")`` past the end of a block of
    draws. Also the host's time to draw each network's parameters anew."""
    import torch
    import torch_prng_check as pc

    from eitx_torch.models.yolo import init as yolo_init
    from eitx_torch.models.yolo.infer import TissueSegmenter
    from eitx_torch.models.yolo.model import yolov11_spec
    from eitx_torch.train.data import _DRAW_BLOCK

    fx = pc.load_fixture()
    check(fx["meta"]["trainer_n"] == dict(TRAIN_SEG, seed=0),
          "the fixture's trainer is not the train phase's")
    init_host_s = {}
    for name, spec in (("n", trainer.model.spec), ("s", yolov11_spec("s"))):
        yolo_init._flax_init_trees.cache_clear()
        t0 = time.perf_counter()
        yolo_init.flax_init_state(spec, 0)
        init_host_s[name] = time.perf_counter() - t0
    seg = TissueSegmenter(device=dev, **fx["meta"]["segmenter_s"])
    params = {
        "trainer_n": pc.leaf_errors(fx, "trainer_n", {
            **trainer.state.params, **trainer.state.batch_stats}),
        "segmenter_s": pc.leaf_errors(fx, "segmenter_s",
                                      seg.model.state_dict())}
    del seg
    steps = fx["meta"]["stream"]["steps"]
    it = pc.stream(fx, dev)
    batches = [next(it)]  # the store's upload (a synchronous copy)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(1, _DRAW_BLOCK + 2):  # into the second block
            b = next(it)
            if i < steps:
                batches.append(b)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    stream = pc.stream_errors(fx, batches)
    ulp = max(p.get("max_ulp", -1) for p in params.values())
    emit("prng", ulp_bound=ulp, init_host_s=init_host_s, params=params,
         stream=dict(stream, steps_without_sync=_DRAW_BLOCK + 1,
                     draw_block=_DRAW_BLOCK))
    for net, p in params.items():
        check(p.get("names_equal") and not p["leaves_differ"]
              and p["sums_equal"] and p["max_ulp"] == 0,
              f"{net}'s initial parameters vs the JAX package's: {p}")
    check(not stream["draws_differ"] and not stream["batches_differ"],
          f"device_batches vs the JAX package's: {stream}")


def phase_train(dev, image):
    """The training path on the card: the YOLOv11-n segmenter at 512 and
    the rib detector at 640 through ``Trainer``, ``device_batches`` and
    ``fit`` with the EMA; ms per step, images per second, peak memory, a
    profiled stretch (idle share, top kernels); one step on the card
    against the same step on the CPU; each network's run again from seed
    0, equal to the first in every leaf of state; a ``.train`` round trip
    that continues as the run it came from, to the bit; the deployment
    file labelling the 512^2 phantom on the card. Returns the segmenter's
    phantom store."""
    import torch

    from eitx_torch.models.yolo.checkpoint import (
        torch_to_flax_tree,
        write_msgpack_checkpoint,
    )
    from eitx_torch.models.yolo.infer import TissueSegmenter
    from eitx_torch.train import TrainConfig, Trainer
    from eitx_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from eitx_torch.train.data import device_batches
    from eitx_torch.train.phantoms import phantom_batch, rib_batch
    from eitx_torch.train.trainer import fit

    t0 = time.perf_counter()
    size = TRAIN_SEG["imgsz"]
    store = phantom_batch(TRAIN_SEG_STORE, size, TRAIN_SEG["max_instances"],
                          np.random.default_rng(0), mask_res=TRAIN_MASK_RES,
                          store_u8=True, device=dev)
    store_s = time.perf_counter() - t0
    check(store["valid"].sum(1).min() >= 4, "a phantom has under 4 targets")
    cfg = TrainConfig(**TRAIN_SEG)
    trainer = Trainer(cfg, seed=0, device=dev)
    check_prng(dev, trainer)
    stream = device_batches(store, TRAIN_SEG_BATCH, seed=0, device=dev)
    first = None
    for _ in range(3):  # warm-up: cuDNN's choices, the allocator
        m = trainer.train_step(next(stream))
        first = first or m
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = 20
    step_ms, (last, ema) = _timed_steps(
        lambda: fit(trainer, stream, steps, log_every=0), steps)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(v) for v in last.values()),
          f"non-finite metrics {last}")
    check(last["loss"] < first["loss"], f"loss {first['loss']} -> "
          f"{last['loss']} over {steps + 3} steps")
    check(trainer.state.step == steps + 3, "step count")
    # the same seed gives the same run: a second run of these 3 + 20 steps
    repro = {"segmenter": (state_digests(trainer, ema), seeded_run_digests(
        TRAIN_SEG, store, TRAIN_SEG_BATCH, 3, steps, dev))}
    profile = profiled_request(lambda: [
        trainer.train_step(next(stream), device_metrics=True)
        for _ in range(5)])

    # one step on the card against the same step on the CPU (two images
    # of a batch: the CPU's step at 512^2 takes seconds an image)
    vs_cpu = step_card_vs_cpu(
        cfg, {k: v[:2] for k, v in next(stream).items()}, 1, dev)
    loss_rel, stats_err = vs_cpu["loss_rel"], vs_cpu["batch_stats_of_scale"]
    check(max(loss_rel.values()) <= CARD_VS_CPU_LOSS_RTOL,
          f"card vs CPU loss {loss_rel}")
    check(stats_err <= TRAIN_STATS_OF_SCALE,
          f"card vs CPU batch_stats {stats_err} of scale")
    # the bounds must tell the TF32 step from the float32 one
    tf32 = vs_cpu["tf32_control"]
    check(max(tf32["loss_rel"].values()) > CARD_VS_CPU_LOSS_RTOL
          or tf32["batch_stats_of_scale"] > TRAIN_STATS_OF_SCALE,
          f"the TF32 step passes the bounds: {tf32}")

    with tempfile.TemporaryDirectory() as tmp:
        # a .train file continues as the run it came from
        path = os.path.join(tmp, "seg.train")
        save_checkpoint(path, trainer.state)
        resumed = Trainer(cfg, seed=7, device=dev)
        resumed.state = load_checkpoint(path, resumed.state)
        # the resumed step and the next: every leaf of state equal to the
        # continuing run's, and so are the metrics
        resume = []
        for _ in range(2):
            batch = next(stream)
            m_res, m_cont = resumed.train_step(batch), trainer.train_step(
                batch)
            resume.append(dict(metrics_equal=m_res == m_cont,
                               leaves_differ=digests_differ(
                                   state_digests(resumed),
                                   state_digests(trainer))))
        check(resumed.state.step == trainer.state.step
              and resumed.opt_state.count == trainer.opt_state.count,
              "the resumed step count")
        check(all(r["metrics_equal"] and not r["leaves_differ"]
                  for r in resume),
              f"the resumed run differs from the continuing one: {resume}")
        # the deployment file: EMA parameters, batch statistics, meta
        deploy = os.path.join(tmp, f"tissue_n_{size}.msgpack")
        write_msgpack_checkpoint(deploy, {
            "params": torch_to_flax_tree(ema)[0],
            "batch_stats": torch_to_flax_tree(trainer.state.batch_stats)[1],
            "meta": {"variant": "n", "imgsz": size, "nc": 4,
                     "steps": int(trainer.state.step),
                     "mask_res": TRAIN_MASK_RES, "mask_topk": 160,
                     "proto_stride": 4}})
        seg = TissueSegmenter(size, weights=deploy, variant="n",
                              dtype="float32", device=dev)
        labels, _ = seg.predict_labels(image)
    check(labels.shape == image.shape[:2] and labels.min() >= -1
          and labels.max() <= 3, f"labels {labels.shape}")

    # the rib detector at 640
    ribs = rib_batch(TRAIN_RIBS_STORE, TRAIN_RIBS["imgsz"],
                     TRAIN_RIBS["max_instances"],
                     np.random.default_rng(0))
    rtrainer = Trainer(TrainConfig(**TRAIN_RIBS), seed=0, device=dev)
    rstream = device_batches(ribs, TRAIN_RIBS_BATCH, seed=0, device=dev)
    rfirst = rtrainer.train_step(next(rstream))
    rtrainer.train_step(next(rstream))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rsteps = 10
    rstep_ms, (rlast, rema) = _timed_steps(
        lambda: fit(rtrainer, rstream, rsteps, log_every=0), rsteps)
    rpeak = torch.cuda.max_memory_allocated() / 2**30
    repro["ribs"] = (state_digests(rtrainer, rema), seeded_run_digests(
        TRAIN_RIBS, ribs, TRAIN_RIBS_BATCH, 2, rsteps, dev))
    repro = {k: dict(steps=int(s), leaves=len(a),
                     leaves_differ=digests_differ(a, b))
             for (k, (a, b)), s in zip(repro.items(), (
                 steps + 3, rsteps + 2))}
    emit("train_repro", runs_from_seed=2, **repro)
    check(not any(r["leaves_differ"] for r in repro.values()),
          f"two runs from seed 0 differ: {repro}")
    check(all(np.isfinite(v) for v in rlast.values()),
          f"non-finite rib metrics {rlast}")
    emit("train", segmenter=dict(
        config=TRAIN_SEG, batch=TRAIN_SEG_BATCH, store=TRAIN_SEG_STORE,
        mask_res=TRAIN_MASK_RES, store_s=store_s, step_ms=step_ms,
        images_per_s=TRAIN_SEG_BATCH * 1e3 / step_ms,
        peak_memory_gib=peak_gib, first_loss=first, last_loss=last,
        profile_5_steps=profile),
        card_vs_cpu=dict(images=2, seed=1, **vs_cpu,
                         loss_rtol_bound=CARD_VS_CPU_LOSS_RTOL,
                         stats_bound=TRAIN_STATS_OF_SCALE),
        resume=dict(steps=resume, step=int(trainer.state.step)),
        deployment=dict(labels_classes=sorted(int(c) for c in
                                              np.unique(labels))),
        ribs=dict(config=TRAIN_RIBS, batch=TRAIN_RIBS_BATCH,
                  store=TRAIN_RIBS_STORE, step_ms=rstep_ms,
                  images_per_s=TRAIN_RIBS_BATCH * 1e3 / rstep_ms,
                  peak_memory_gib=rpeak, first_loss=rfirst, last_loss=rlast))
    return store


# the parallel phase: a world of one card on NCCL, joined through a file;
# the blocks that the ranks of a world of PARALLEL_WORLD compute, on the card
PARALLEL_STEPS, PARALLEL_TIMED = 3, 5
PARALLEL_SEG_IMAGES = 16
PARALLEL_WORLD = 4


def _seg_variants(image, n: int) -> np.ndarray:
    """The first ``n`` of the eval phase's flips and shifts of ``image``."""
    k = len(VARIANT_SHIFTS)
    return np.stack([_variant(image, i % k, i // k) for i in range(n)])


def _dat_bytes(path: str, v, n_points: int, n_repeats: int) -> bytes:
    from eitx_torch.fem.forward import write_dat

    write_dat(path, v.cpu().numpy().reshape(n_points, -1), n_repeats)
    with open(path, "rb") as fh:
        return fh.read()


def phase_parallel(dev, image, store):
    """The sharded paths of eitx_torch.parallel on a world of one card
    (NCCL, a FileStore): Trainer on a (1, 1) mesh against the meshless
    trainer from one init (losses and every leaf of state to the bit, ms
    per step, peak memory); sharded_eit_monitoring, sharded_segment_labels
    and sharded_group_solve against their single-device calls. At a world of
    one these equalities check the wiring (a rank's block is the whole
    run); the blocks that the ranks of a world of PARALLEL_WORLD compute,
    run one after another on the card, check that the blocks reassemble
    the single-device results. Returns the kernel launches of its
    meshing."""
    import torch
    import torch.distributed as dist

    from eitx_torch.core.config import ClassMap, ModelConfig, SimulationConfig
    from eitx_torch.fem import LowRankSpectralSolver, forward_solve_batched
    from eitx_torch.fem.solver import solve_stack_frames
    from eitx_torch.mesh import create_mesh, pip
    from eitx_torch.models.yolo.infer import TissueSegmenter
    from eitx_torch.parallel import (
        init_distributed,
        make_device_mesh,
        sharded_eit_monitoring,
        sharded_group_solve,
        sharded_segment_labels,
    )
    from eitx_torch.parallel.shard import (
        group_solve_block,
        labels_block,
        monitoring_block,
    )
    from eitx_torch.train import TrainConfig, Trainer
    from eitx_torch.train.data import device_batches

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(0, 1, os.path.join(tmp, "store"), "cuda")
        try:
            check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                  f"process group {dist.get_backend()}")
            mesh2 = make_device_mesh(("data", "model"), (1, 1))
            fmesh = make_device_mesh(("data",))

            # training: the (1, 1) mesh against no mesh, one init, one stream
            cfg = TrainConfig(**TRAIN_SEG)
            plain = Trainer(cfg, seed=0, device=dev)
            sharded = Trainer(cfg, mesh=mesh2, seed=0, device=dev)
            check(all(torch.equal(a, b) for a, b in zip(
                plain.state.params.values(),
                sharded.state.params.values())), "the two inits differ")
            runs = {}
            for name, tr in (("plain", plain), ("mesh", sharded)):
                stream = device_batches(store, TRAIN_SEG_BATCH, seed=0,
                                        device=dev)
                steps = [tr.train_step(next(stream))
                         for _ in range(PARALLEL_STEPS)]
                digests = state_digests(tr)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                step_ms, _ = _timed_steps(lambda: [
                    tr.train_step(next(stream), device_metrics=True)
                    for _ in range(PARALLEL_TIMED)], PARALLEL_TIMED)
                runs[name] = dict(
                    steps=steps, digests=digests, step_ms=step_ms,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    digests_timed=state_digests(tr))
            # a group of one computes the single-device step: every leaf
            # of state equal after the compared steps and the timed ones
            losses_equal = runs["mesh"]["steps"] == runs["plain"]["steps"]
            mesh_differ = {k: digests_differ(runs["mesh"][k],
                                             runs["plain"][k])
                           for k in ("digests", "digests_timed")}
            check(losses_equal, f"mesh vs meshless losses "
                  f"{runs['mesh']['steps']} vs {runs['plain']['steps']}")
            check(not any(mesh_differ.values()),
                  f"mesh vs meshless state differs: {mesh_differ}")
            train_s = time.perf_counter() - t0

            # monitoring: the serving schedule's frames on an lc-7 thorax
            sim = SimulationConfig()
            pip.pip_launches = 0
            meshes = []
            for seed, lc in FACTORY_SUBJECTS:
                _, m = create_mesh(["0.75", "0.75"], thorax_polygons(seed),
                                   lc=lc, show_meshing_result_method="no",
                                   device=dev)
                meshes.append(m)
            torch.cuda.synchronize()
            launches = pip.pip_launches
            check(launches == len(meshes),
                  f"pip kernel launched {launches} times for {len(meshes)}")
            systems = [subject_system(m, sim, dev) for m in meshes]
            _, sigma, proto, el, cs = systems[0]
            # the .dat's 1200 rows: the schedule's frames, 12 times over
            n_rep = sim.n_spir * sim.n_minutes
            frames = np.concatenate([sigma] * n_rep)
            mon_args = (cs, frames, el, proto.ex_mat, proto.meas_mat)
            stack = solve_stack_frames(cs, len(frames))
            # peak memory: what a call allocates above the tensors alive
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            v_one, one_s = _time_call(
                lambda: forward_solve_batched(*mon_args))
            one_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
            v_shard, mon_s = _time_call(lambda: sharded_eit_monitoring(
                *mon_args, mesh=fmesh))
            check(v_shard.shape == v_one.shape == (len(frames), 16, 13),
                  f"monitoring {tuple(v_shard.shape)}")
            check(torch.equal(v_shard, v_one),
                  "sharded monitoring != forward_solve_batched")
            # the blocks of a world of PARALLEL_WORLD, one after another
            blocks, block_s, block_gib = [], [], 0.0
            for r in range(PARALLEL_WORLD):
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                v, t = _time_call(lambda: monitoring_block(
                    *mon_args, r, PARALLEL_WORLD))
                blocks.append(v)
                block_s.append(t)
                block_gib = max(block_gib, (torch.cuda.max_memory_allocated()
                                            - base) / 2**30)
            check(torch.equal(torch.cat(blocks)[:len(frames)], v_one),
                  f"monitoring blocks of {PARALLEL_WORLD} ranks != one call")
            del blocks, v_shard

            # segmentation: 16 flips and shifts through the trained 512
            # checkpoint at the serving settings
            m = ModelConfig()
            seg = TissueSegmenter(512, weights=os.path.join(
                WEIGHTS, "tissue_n_512.msgpack"), variant="n",
                conf=m.axial_conf_per_class, max_det=m.max_detections,
                tta_fill=m.axial_tta_fill, dtype=m.dtype, device=dev)
            imgs = _seg_variants(image, PARALLEL_SEG_IMAGES)
            seg.segment_labels(imgs)  # warm-up: cuDNN's choices
            lab_shard, seg_s = _time_call(
                lambda: sharded_segment_labels(seg, imgs, fmesh))
            lab_one, single_seg_s = _time_call(
                lambda: seg.segment_labels(imgs))
            agree = float((lab_shard == lab_one).mean())
            check(agree >= 0.99, f"sharded labels agree {agree}")
            coarse = torch.cat([labels_block(seg, imgs, r, PARALLEL_WORLD)
                                for r in range(PARALLEL_WORLD)])
            lab_blocks = np.empty_like(lab_one)
            seg._upsample_labels_into(lab_blocks, coarse.cpu().numpy(), q=4)
            agree_blocks = float((lab_blocks == lab_one).mean())
            check(agree_blocks >= 0.99,
                  f"labels of {PARALLEL_WORLD} ranks' blocks agree "
                  f"{agree_blocks}")

            # the factory's nine subjects: solvers per node bucket, as
            # generate_batch builds them; the group solve over 'data'
            classes = ClassMap()
            lung = classes.name_to_id()["lung"]
            alphas = sigma[:, lung]
            a0 = float(alphas.mean())
            groups = collections.defaultdict(list)
            for i, (_, _, _, _, c) in enumerate(systems):
                groups[tuple(c.k_class.shape)].append(i)
            solvers = [None] * len(systems)
            for idxs in groups.values():
                built = LowRankSpectralSolver.build_batch(
                    [systems[i][4] for i in idxs], sigma[0], lung,
                    [systems[i][3] for i in idxs], proto.ex_mat,
                    proto.meas_mat, [a0] * len(idxs),
                    rank_bucket=sim.spectral_rank_bucket)
                for i, sv in zip(idxs, built):
                    solvers[i] = sv
            v_group, group_s = _time_call(
                lambda: sharded_group_solve(solvers, alphas, fmesh))
            v_blocks = torch.cat([
                group_solve_block(solvers, alphas, r, PARALLEL_WORLD)
                for r in range(PARALLEL_WORLD)])
            check(all(torch.equal(v_blocks[k], v) for k, v in
                      enumerate(v_group)),
                  f"group solve of {PARALLEL_WORLD} ranks' blocks != one")
            t1 = time.perf_counter()
            for k, sv in enumerate(solvers):
                a = _dat_bytes(os.path.join(tmp, f"single{k}.dat"),
                               sv.solve(alphas), sim.n_points, n_rep)
                b = _dat_bytes(os.path.join(tmp, f"shard{k}.dat"),
                               v_group[k], sim.n_points, n_rep)
                check(a == b, f"subject {k}: sharded .dat bytes differ")
                check(a.count(b"\n") == sim.n_points * n_rep,
                      f"subject {k}: .dat rows")
            dat_s = time.perf_counter() - t1
        finally:
            dist.destroy_process_group()
    emit("parallel", backend="nccl", world_size=1,
         train=dict(config=TRAIN_SEG, batch=TRAIN_SEG_BATCH,
                    compared_steps=PARALLEL_STEPS,
                    losses_equal=losses_equal,
                    leaves=len(runs["plain"]["digests"]),
                    leaves_differ_after_compared=mesh_differ["digests"],
                    leaves_differ_after_timed=mesh_differ["digests_timed"],
                    step_ms_mesh=runs["mesh"]["step_ms"],
                    step_ms_plain=runs["plain"]["step_ms"],
                    peak_gib_mesh=runs["mesh"]["peak_gib"],
                    peak_gib_plain=runs["plain"]["peak_gib"], s=train_s,
                    losses_mesh=runs["mesh"]["steps"],
                    losses_plain=runs["plain"]["steps"]),
         monitoring=dict(frames=len(frames), stack_frames=stack,
                         nodes_padded=int(cs.n_nodes), equal=True,
                         sharded_s=mon_s, single_s=one_s,
                         single_peak_gib=one_gib,
                         blocks_of=PARALLEL_WORLD, blocks_equal=True,
                         block_s=block_s, block_peak_gib=block_gib),
         labels=dict(images=PARALLEL_SEG_IMAGES, agreement=agree,
                     equal=agree == 1.0, sharded_s=seg_s,
                     single_s=single_seg_s, blocks_of=PARALLEL_WORLD,
                     blocks_agreement=agree_blocks),
         group_solve=dict(subjects=len(solvers), buckets=len(groups),
                          blocks_of=PARALLEL_WORLD, blocks_equal=True,
                          dat_rows=sim.n_points * n_rep, dat_cols=208,
                          dat_bytes_equal=True, s=group_s,
                          dat_write_s=dat_s),
         pip_launches=launches)
    return launches


def phase_scripts(dev, series):
    """The profiling and dataset scripts on the card: profile_seg (512,
    batch 16), profile_setup (batch 8), eval_ood_fixture at 512 with one
    seed on the trained checkpoint, build_datasets frontal on the series
    zip."""
    from eitx_torch.io import decode_image
    from eitx_torch.scripts import (
        build_datasets,
        eval_ood_fixture,
        profile_seg,
        profile_setup,
    )

    t0 = time.perf_counter()
    seg = profile_seg.profile(512, 16, 3, device=dev)
    check(seg["network"]["gflops"] > 0 and seg["fused_e2e"]["ms"] > 0,
          f"profile_seg {seg}")
    seg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    setup = profile_setup.profile(8, 3, device=dev)
    check(setup["build"]["single_ms"] > 0, f"profile_setup {setup}")
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ood = eval_ood_fixture.main(["--sizes", "512", "--seeds", "1",
                                 "--device", str(dev)])["512"]
    # tests/test_ood_fixture.py's ratchets at the 512 slot (seed 5)
    check(ood["macro_iou"] >= 0.76 and ood["per_class_iou"]["muscles"]
          >= 0.75 and ood["per_class_iou"]["fat"] >= 0.83, f"ood {ood}")
    ood_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        zp = os.path.join(tmp, "series.zip")
        with open(zp, "wb") as fh:
            fh.write(series.getvalue())
        out = os.path.join(tmp, "front")
        n = build_datasets.build_frontal_dataset([zp], out, device=dev)
        files = sorted(os.listdir(out))
        with open(os.path.join(out, files[SERIES_SIZE // 2]), "rb") as fh:
            mid = decode_image(fh.read())
    check(n == len(files) == SERIES_SIZE, f"frontal images {n}")
    check(mid.shape == (SERIES_SLICES, SERIES_SIZE) and mid.max() == 255,
          f"frontal image {mid.shape} max {mid.max()}")
    emit("scripts", profile_seg=seg, profile_seg_s=seg_s,
         profile_setup=setup, profile_setup_s=setup_s,
         eval_ood_fixture=ood, eval_ood_s=ood_s,
         build_frontal=dict(images=n, s=time.perf_counter() - t0))


# examples/torch/ at the sizes of tests/test_torch_examples.py: each
# script's main arguments given its working directory
EXAMPLES = {
    "building_floorplan": lambda d: (),
    "spiral_art": lambda d: (),
    "gear_section": lambda d: (),
    "eit_monitoring": lambda d: (d, 14.0, 4),
    "real_slice_demo": lambda d: (d, 14.0, 4),
    "auto_mode_demo": lambda d: (),
}
# meshes the six make: one each, four, one, one a request of two
EXAMPLE_MESHES = 3 + 4 + 1 + 2


def phase_examples(dev) -> int:
    """The six examples of examples/torch/ on the card, each in a fresh
    working directory: their results and each one's wall time. Returns
    the kernel's launches."""
    import importlib.util

    import torch

    from eitx_torch.mesh import pip

    walls, out = {}, {}
    cwd = os.getcwd()
    pip.pip_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for name, args in EXAMPLES.items():
                work = os.path.join(tmp, name)
                os.makedirs(work)
                os.chdir(work)
                spec = importlib.util.spec_from_file_location(
                    f"example_{name}",
                    os.path.join(ROOT, "examples", "torch", f"{name}.py"))
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                t0 = time.perf_counter()
                out[name] = mod.main(*args(work), device=str(dev))
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t0
                check(any(f.endswith((".png", ".dat")) or f ==
                          "generation_results" for f in os.listdir(work)),
                      f"{name} wrote nothing")
        finally:
            os.chdir(cwd)
    launches = pip.pip_launches
    check(launches == EXAMPLE_MESHES,
          f"pip kernel launched {launches} times in the examples")
    for name in ("building_floorplan", "spiral_art", "gear_section"):
        check(len(out[name]["TRIANGLES"]) > 0, f"{name} mesh")
    for name in ("eit_monitoring", "real_slice_demo"):
        v = out[name][0]
        check(v.shape == (4, 208) and np.isfinite(v).all(), f"{name} {v.shape}")
    check(out["auto_mode_demo"]["status"] == "success"
          and len(out["auto_mode_demo"]["tissue_classes_in_answer"]) >= 3,
          f"auto_mode_demo {out['auto_mode_demo']}")
    emit("examples", wall_s=walls, pip_launches=launches,
         auto_mode=out["auto_mode_demo"])
    return launches


BENCH_SECTIONS = ("bench_eit", "bench_dataset_factory")


def phase_bench(dev) -> int:
    """bench_torch.py's sections in ``BENCH_SECTIONS`` at their full
    sizes (the lc-7 thorax at 1200 frames; 4 + 1 phantom slices through
    the serving pipeline), in this process: the bench prints its own
    lines and exits 0 only if every section's check holds. Returns the
    kernel's launches."""
    import bench_torch
    from eitx_torch.mesh import pip

    pip.pip_launches = 0
    rc = bench_torch.main(
        [arg for name in BENCH_SECTIONS for arg in ("--section", name)]
        + ["--device", str(dev)])
    launches = pip.pip_launches
    check(rc == 0, f"bench_torch exited {rc}: a section's check failed")
    check(launches > 0, "the bench's sections did not launch the pip kernel")
    emit("bench", sections=list(BENCH_SECTIONS), rc=rc, pip_launches=launches)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))  # torch_series_phantom
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    fixture = np.load(os.path.join(DATA, "torch_smoke_512.npz"))
    image, ref_labels = fixture["image"], fixture["labels"]
    series_fixture = np.load(os.path.join(DATA, "torch_series_512.npz"))

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        torch.cuda.synchronize()
        emit("seconds", of=phase.__name__, s=time.perf_counter() - t0)
        return out

    def series_inputs():
        from eitx_torch.image import minmax_normalize_u8
        from torch_series_phantom import series_volume

        vol = series_volume(int(series_fixture["seed"]), SERIES_SLICES,
                            SERIES_SIZE)
        front = minmax_normalize_u8(vol[:, SERIES_SIZE // 2, :], device=dev)
        return vol, front.cpu().numpy()

    timed(phase_env)
    timed(phase_kernel, dev)
    timed(phase_edge_cases, dev)
    mesh = timed(phase_mesh, dev)
    timed(phase_fem, dev, mesh)
    launches, (points, polys) = timed(phase_pipeline, dev, image)
    main_path = compare_pip(points, polys)
    emit("kernel_pip", inputs="main path, request 1", **main_path)
    timed(phase_labels, dev, image, ref_labels, fixture["labels_bf16"])
    timed(phase_image, dev)
    vol, front = timed(series_inputs)
    timed(phase_ribs, dev, front, series_fixture)
    series_launches, (points, polys), series = timed(
        phase_series, dev, vol, series_fixture, image)
    launches += series_launches
    emit("kernel_pip", inputs="series path, request 1",
         **compare_pip(points, polys, timed=False))
    factory_launches, (points, polys) = timed(phase_factory, dev)
    launches += factory_launches
    emit("kernel_pip", inputs="factory path, subject 0",
         **compare_pip(points, polys, timed=False))
    timed(phase_solvers, dev, mesh)
    launches += timed(phase_inverse, dev)
    launches += timed(phase_serve, dev, image, series,
                      int(series_fixture["slice_index"]) + 1)
    timed(phase_eval, dev, image, ref_labels)
    store = timed(phase_train, dev, image)
    launches += timed(phase_parallel, dev, image, store)
    del store
    timed(phase_scripts, dev, series)
    del series
    launches += timed(phase_examples, dev)
    launches += timed(phase_bench, dev)

    print(json.dumps({"kernels": [{
        "name": "pip",
        "route": "cuda",
        "source": "eitx_torch/csrc/pip.cu",
        "replaces": "eitx/mesh/pallas_pip.py:37",
        "launches": launches,
        "max_abs_err": main_path["max_abs_err"],
        # device time of a call, calls queued back to back; call_ms is one
        # call between two events, which for a call this short is the
        # host's time to enqueue it
        "ms": main_path["ms"],
        "call_ms": main_path["call_ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(gpu_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,  # the one card this script drives
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
