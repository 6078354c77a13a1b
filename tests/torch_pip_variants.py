"""Times variants of the point-in-polygon kernel on one NVIDIA GPU.

    python tests/torch_pip_variants.py            # the standard set
    python tests/torch_pip_variants.py '[["kPPT=4"], ["no_hit_loop"], ["x.cu"]]'

A variant is ``eitx_torch/csrc/pip.cu`` with some of its text replaced
before it is built: a tuning constant given another value (``kName=value``
for a ``constexpr int kName`` of the source), one of the edits in
``EDITS``, which cut a part out of the kernel to show what that part costs
(such a build computes wrong answers, and its line says ``equal: false``),
or another source file with the same C interface in place of the whole
(a path ending in ``.cu``). Every variant is held against the plain
version and timed on two inputs of the main path's shape (Q 32768, C 32,
P 512): random polygons, where every edge is live and the points lie
anywhere (the dense worst case), and the inputs that one
``Pipeline.run_jpg_png`` request on the committed 512 x 512 slice gives the
kernel. Times are device times of one call (prologue and main kernel) with
calls queued back to back (``chip_smoke.device_ms``), in microseconds; one
JSON line per variant, the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import device_ms, gpu_name_and_limit  # noqa: E402
from eitx_torch._build import BUILD_DIR, build_shared  # noqa: E402
from eitx_torch.mesh import pip  # noqa: E402

# name -> (text in pip.cu, its replacement)
EDITS = {
    # the straddle bits are taken, the crossings are not computed
    "no_hit_loop": [("while (__any_sync(kFull, left != 0u)) {",
                     "w.par[0] ^= left; while (false) {")],
    # every group is dropped after the look at its records' reach
    "reach_only": [("  if (reach == 0u) return;",
                    "  if (reach != 0xdeadbeefu) return;")],
    # no group is looked at: launches, the walk over the list, the rows' stores
    "no_groups": [("  bool in_reach = false;\n",
                   "  return;\n  bool in_reach = false;\n")],
    # no kernel starts before the one ahead of it has ended
    "no_overlap": [
        ("  attr.val.programmaticStreamSerializationAllowed = 1;",
         "  attr.val.programmaticStreamSerializationAllowed = 0;")],
    # only the prologue's second kernel starts early, not the main kernel
    "plain_main": [
        ("  const cudaError_t launched = launch_overlapped(\n"
         "      pip_main_kernel<kPPT>, (Q + kPerBlock - 1) / kPerBlock, "
         "kThreads, s, pts,\n"
         "      records, offsets, out, Q, C);",
         "  pip_main_kernel<kPPT><<<(Q + kPerBlock - 1) / kPerBlock, kThreads, "
         "0, s>>>(\n"
         "      (const float2*)pts, (const float4*)records, (const int*)offsets,"
         "\n      (uint8_t*)out, Q, C);\n"
         "  const cudaError_t launched = cudaSuccess;")],
}


def _tuning(threads: int, ppt: int, group: int) -> list:
    return [f"kThreads={threads}", f"kPPT={ppt}", f"kGroup={group}"]


STANDARD = [
    [], _tuning(128, 1, 32), _tuning(256, 2, 32), _tuning(256, 4, 32),
    _tuning(512, 1, 32), _tuning(512, 2, 32), _tuning(256, 1, 16),
    ["kSparse=0"], ["kSparse=4"], ["kSparse=16"],
    ["plain_main"], ["no_overlap"],
    ["no_hit_loop"], ["reach_only"], ["no_groups"], [],
]


def random_inputs(dev, q: int = 32768, c: int = 32, p: int = 512):
    rng = np.random.default_rng(0)
    points = rng.uniform(0, 512, (q, 2))
    centres = rng.uniform(64, 448, (c, 1, 2))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (c, p)), axis=1)
    rad = rng.uniform(10, 120, (c, p))
    polys = centres + np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    return (torch.as_tensor(points, dtype=torch.float32, device=dev),
            torch.as_tensor(polys, dtype=torch.float32, device=dev))


def main_path_inputs(dev):
    """What one ``run_jpg_png`` request hands to ``points_in_polys``."""
    from eitx_torch.core.config import ModelConfig, PipelineConfig
    from eitx_torch.mesh import classify
    from eitx_torch.pipeline import Pipeline

    image = np.load(os.path.join(ROOT, "tests", "data",
                                 "torch_smoke_512.npz"))["image"]
    seen = []
    launch = classify.points_in_polys

    def record(points, polys):
        seen.append((points.clone(), polys.clone()))
        return launch(points, polys)

    classify.points_in_polys = record
    try:
        with tempfile.TemporaryDirectory() as results:
            cfg = PipelineConfig(
                model=ModelConfig(axial_weights_512=os.path.join(
                    ROOT, "weights", "tissue_n_512.msgpack")),
                results_dir=results)
            Pipeline(cfg, device=dev).run_jpg_png(image)
    finally:
        classify.points_in_polys = launch
    return seen[0]


def variant_source(variant: list) -> str:
    with open(pip._SRC) as fh:
        source = fh.read()
    for item in variant:
        if item.endswith(".cu"):
            with open(item) as fh:
                source = fh.read()
            continue
        if item in EDITS:
            edits = EDITS[item]
        else:
            name, value = item.split("=")
            was = re.search(rf"constexpr int {name} = \d+;", source)
            if was is None:
                raise ValueError(f"no constant {name!r} in the source")
            edits = [(was.group(0), f"constexpr int {name} = {int(value)};")]
        for old, new in edits:
            if source.count(old) != 1:
                raise ValueError(
                    f"edit {item!r} does not fit the source: {old!r}")
            source = source.replace(old, new)
    return source


def build_variant(variant: list) -> ctypes.CDLL:
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "pip_variant.cu")
    with open(path, "w") as fh:
        fh.write(variant_source(variant))
    lib = ctypes.CDLL(build_shared(path, "libeitxpipvariant",
                                   [pip._nvcc(), *pip.NVCC_FLAGS]))
    lib.eitx_pip.restype = ctypes.c_int
    lib.eitx_pip.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return lib


def time_variant(lib: ctypes.CDLL, points, polys, want) -> dict:
    q, (c, p) = points.shape[0], polys.shape[:2]
    out = torch.empty((q, c), dtype=torch.uint8, device=points.device)
    scratch = pip._scratch(c, p, points.device)

    def call():
        rc = lib.eitx_pip(points.data_ptr(), polys.data_ptr(), out.data_ptr(),
                          *[t.data_ptr() for t in scratch], q, c, p,
                          torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"eitx_pip launch failed: CUDA error {rc}")

    call()
    torch.cuda.synchronize()
    return dict(us=device_ms(call) * 1e3,
                equal=bool(torch.equal(out.view(torch.bool), want)))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_pip_variants: no CUDA device", file=sys.stderr)
        return 1
    variants = json.loads(argv[1]) if len(argv) > 1 else STANDARD
    dev = torch.device("cuda", 0)
    print(gpu_name_and_limit(), flush=True)
    inputs = {"random": random_inputs(dev), "main_path": main_path_inputs(dev)}
    wanted = {k: pip.points_in_polys_ref(*v) for k, v in inputs.items()}
    for variant in variants:
        lib = build_variant(variant)
        line = {"variant": variant or ["as committed"]}
        for name, (points, polys) in inputs.items():
            line[name] = time_variant(lib, points, polys, wanted[name])
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
