"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives eitx_torch's main path — ``Pipeline.run_jpg_png`` on a 512x512
axial slice with the trained YOLOv11-n tissue segmenter (bf16, per-class
conf, 4 flip views), default mesh (lc 7) and the default simulation
(16 electrodes, 100 points x 12 breaths, low-rank spectral solve) — and
holds every hand-written kernel against its plain PyTorch version.

Phases, one JSON line each; any failure raises and exits non-zero:
  env       torch / CUDA versions, the card, the kernel and native builds
  kernel_pip  the point-in-polygon kernel vs its plain version at the main
            path's width (Q 32768, C 32, P 512) and on known points
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
            float32 labels committed in tests/data/torch_smoke_512.npz
Then the kernels line, the card's name and power limit, and the result
line. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the crossing test of one (point, edge) pair: y - y1, 1 product,
# 1 division, 1 addition and 3 comparisons (y1 > y, y2 > y, x < xc); the
# select and the parity update are not counted
PIP_OPS_PER_PAIR = 7
# terms of one edge, whatever the point: x2 - x1, y2 - y1 and dy == 0
PIP_OPS_PER_EDGE = 3

GOLD_NODES, GOLD_TRIS = 2107, 4041
GOLD_HIST = {0: 243, 1: 563, 2: 1669, 3: 1565, 4: 1}
GOLD_ROW0 = np.array(
    [3.27767618, 0.16383494, 0.15325824, 0.12928992, 0.03966795, 0.02340173])
GOLD_ROW5 = np.array(
    [0.07548676, 0.08194821, 0.05308934, 0.31663108, 1.00702802, 3.41541427])
GOLD_SUM = 1194.555605
GOLD_ABSMAX = 8.415208


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
    """Median device time of ``fn()`` in ms, from CUDA events."""
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


def pip_bound_ms(q: int, c: int, p: int) -> tuple:
    ops = q * c * p * PIP_OPS_PER_PAIR + c * p * PIP_OPS_PER_EDGE
    nbytes = q * 2 * 4 + c * p * 2 * 4 + q * c
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


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
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), gpu=gpu_name_and_limit(),
         build_s=round(build_s, 3), nvcc_flags=pip.NVCC_FLAGS)


def _random_polys(rng, c: int, p: int) -> np.ndarray:
    centres = rng.uniform(64, 448, (c, 1, 2))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (c, p)), axis=1)
    rad = rng.uniform(10, 120, (c, p))
    return centres + np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)


def compare_pip(points, polys) -> dict:
    """Kernel vs plain version on the same inputs: every element must
    agree. Returns the comparison's numbers."""
    import torch

    from eitx_torch.mesh import pip

    got = pip.points_in_polys(points, polys)
    ref = pip.points_in_polys_ref(points, polys)
    torch.cuda.synchronize()
    err = int((got.to(torch.int8) - ref.to(torch.int8)).abs().max().item())
    check(torch.equal(got, ref), "pip kernel disagrees with its plain version")
    q, (c, p) = points.shape[0], polys.shape[:2]
    bound, bound_by, ops, nbytes = pip_bound_ms(q, c, p)
    ms = cuda_ms(lambda: pip.points_in_polys(points, polys))
    plain_ms = cuda_ms(lambda: pip.points_in_polys_ref(points, polys),
                       reps=5, warmup=1)
    # edges of nonzero length on polygons inside the scene: the tests the
    # answer depends on (padding polygons sit at -1e7, padding vertices
    # repeat the last one)
    live = polys[:, :, 0] > -1e6
    moved = (torch.roll(polys, -1, dims=1) != polys).any(dim=2)
    return dict(shape=[q, c, p], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, ops=ops, bytes=nbytes,
                inside_fraction=float(ref.float().mean().item()),
                live_polygons=int(live[:, 0].sum().item()),
                live_edges=int((live & moved).sum().item()))


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


def phase_pipeline(dev, image):
    import torch

    import eitx_torch.mesh.classify as classify
    from eitx_torch.core.config import ModelConfig, PipelineConfig
    from eitx_torch.core.timing import Timer
    from eitx_torch.fem.forward import write_dat
    from eitx_torch.mesh import pip
    from eitx_torch.pipeline import Pipeline

    recorded = []
    launch = classify.points_in_polys

    def record(points, polys):  # keeps the first request's kernel inputs
        if not recorded:
            recorded.append((points.clone(), polys.clone()))
        return launch(points, polys)

    with tempfile.TemporaryDirectory() as results:
        cfg = PipelineConfig(
            model=ModelConfig(axial_weights_512=os.path.join(
                ROOT, "weights", "tissue_n_512.msgpack")),
            results_dir=results,
        )
        t0 = time.perf_counter()
        pipe = Pipeline(cfg, device=dev)
        load_s = time.perf_counter() - t0
        classify.points_in_polys = record
        try:
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
        finally:
            classify.points_in_polys = launch
        dats = [open(a["saved_file_name"], "rb").read() for a in answers]
        v = np.loadtxt(answers[0]["saved_file_name"])
        profile = profiled_request(pipe, image)
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


def profiled_request(pipe, image) -> dict:
    """One more warm request under torch.profiler: its wall time, the
    device's busy time, the idle share and the ten device kernels with the
    most time. Runs after the kernel counts are read."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.run_jpg_png(image)
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
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1.0 - busy / wall_ms,
                top_kernels_ms=[{"name": n[:80], "ms": ms, "count": k}
                                for n, (ms, k) in top])


def phase_labels(dev, image, ref_labels):
    import torch

    from eitx_torch.core.config import ModelConfig
    from eitx_torch.models.yolo.infer import TissueSegmenter

    m = ModelConfig()
    seg = TissueSegmenter(
        512, weights=os.path.join(ROOT, "weights", "tissue_n_512.msgpack"),
        conf=m.axial_conf_per_class, max_det=m.max_detections,
        tta_fill=m.axial_tta_fill, dtype="float32", device=dev,
    )
    flags = []  # TF32 settings seen by each forward pass of the network
    hook = seg.model.register_forward_pre_hook(lambda *_: flags.append(
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32)))
    try:
        labels, _ = seg.predict_labels(image)
    finally:
        hook.remove()
    check(flags and not any(a or b for a, b in flags),
          f"float32 inference ran with TF32 settings {flags}")
    agree = float((labels == ref_labels).mean())
    check(agree >= 0.99, f"float32 label agreement {agree}")
    emit("labels", dtype="float32", agreement=agree, forward_passes=len(flags),
         classes=sorted(int(c) for c in np.unique(labels)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    fixture = np.load(os.path.join(DATA, "torch_smoke_512.npz"))
    image, ref_labels = fixture["image"], fixture["labels"]

    phase_env()
    phase_kernel(dev)
    mesh = phase_mesh(dev)
    phase_fem(dev, mesh)
    launches, (points, polys) = phase_pipeline(dev, image)
    main_path = compare_pip(points, polys)
    emit("kernel_pip", inputs="main path, request 1", **main_path)
    phase_labels(dev, image, ref_labels)

    print(json.dumps({"kernels": [{
        "name": "pip",
        "route": "cuda",
        "source": "eitx_torch/csrc/pip.cu",
        "replaces": "eitx/mesh/pallas_pip.py:37",
        "launches": launches,
        "max_abs_err": main_path["max_abs_err"],
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(gpu_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
