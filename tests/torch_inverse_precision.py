"""Where the float32 error of the port's difference imaging comes from,
on the real slice meshed at the serving lc 7 (4245 nodes).

    python tests/torch_inverse_precision.py [--device cuda|cpu]

Builds the adjoint Jacobian in float32 and in float64 and, between the
two, variants that change one step: the stiffness K assembled in float32
but factored in float64; K and its factor in float32 with one step of
iterative refinement of the electrode fields; the float64 fields with the
float32 element sums. Prints one JSON line per variant: its Jacobian's
distance from float64 and that of the difference images of the serving
monitoring (1200 frames), both scale-relative, and the card's name and
power limit. Not collected by pytest.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import eitx_torch.fem.inverse as inverse  # noqa: E402
from eitx_torch.core.config import SimulationConfig  # noqa: E402
from eitx_torch.fem import simulate_eit_monitoring  # noqa: E402
from eitx_torch.fem.assembly import (  # noqa: E402
    assemble_stiffness,
    element_geometry,
)
from eitx_torch.mesh import create_mesh  # noqa: E402


def rel_to_max(got, ref) -> float:
    got, ref = (np.asarray(x.cpu().double() if torch.is_tensor(x) else x)
                for x in (got, ref))
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def fields(nodes, tris, sigma, el, n, refine=False, factor_dtype=None):
    """Electrode fields U (N, 16) as _difference_jacobian solves them, with
    the factorization in ``factor_dtype`` and an optional refinement."""
    K = inverse._ground(assemble_stiffness(nodes, tris, sigma, n), 0)
    B = inverse._electrode_rhs(el, n, 0, K.dtype)
    Kf = K.to(factor_dtype or K.dtype)
    L = torch.linalg.cholesky(Kf)
    U = torch.cholesky_solve(B.to(Kf.dtype), L).to(K.dtype)
    if refine:
        U = U + torch.cholesky_solve((B - K @ U).to(Kf.dtype),
                                     L).to(K.dtype)
    return U


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    with open(os.path.join(ROOT, "tests", "data",
                           "real_slice_polygons.txt")) as fh:
        polys = [ln.strip() for ln in fh if ln.strip()
                 and not ln.startswith("#")]
    _, mesh = create_mesh(["1", "1"], polys, 7, 1.3, 1,
                          show_meshing_result_method="no", device=dev)
    cfg = SimulationConfig()
    v, _ = simulate_eit_monitoring(mesh, cfg, device=dev)
    info, sigma_ref, el, proto = inverse.monitoring_linearization(mesh)
    n = info.node.shape[0]
    ix = [torch.as_tensor(np.asarray(a), device=dev)
          for a in (info.element, el, proto.ex_mat, proto.meas_mat)]
    tris, el_t, ex, meas = ix
    vt = torch.as_tensor(np.tile(v, (12, 1)), dtype=torch.float64,
                         device=dev)
    dv = vt - vt[0][None]

    def images(jac):
        chol, info_ = inverse._factor(jac, 1e-3)
        assert int(info_) == 0
        return inverse._reconstruct(jac, chol, dv.to(jac.dtype))

    per_dtype = {}
    for dt in (torch.float32, torch.float64):
        nodes = torch.as_tensor(info.node, dtype=dt, device=dev)
        sigma = torch.as_tensor(sigma_ref, dtype=dt, device=dev)
        ke, _ = element_geometry(nodes, tris)
        per_dtype[dt] = (nodes, sigma, ke)
    nodes64, sigma64, ke64 = per_dtype[torch.float64]
    U64 = fields(nodes64, tris, sigma64, el_t, n)
    J64 = inverse._sensitivity(ke64, tris, U64, ex, meas)
    img64 = images(J64)
    nodes32, sigma32, ke32 = per_dtype[torch.float32]
    variants = {
        "float32 (as the imagers)": lambda: inverse._difference_jacobian(
            nodes32, tris, sigma32, el_t, ex, meas, n),
        "float32 K, float64 factor": lambda: inverse._sensitivity(
            ke32, tris, fields(nodes32, tris, sigma32, el_t, n,
                               factor_dtype=torch.float64), ex, meas),
        "float32, one refinement step": lambda: inverse._sensitivity(
            ke32, tris, fields(nodes32, tris, sigma32, el_t, n, refine=True),
            ex, meas),
        "float64 fields, float32 element sums": lambda: inverse._sensitivity(
            ke32, tris, U64.float(), ex, meas),
    }
    for name, build in variants.items():
        jac = build()
        print(json.dumps({
            "variant": name, "device": str(dev), "nodes": n,
            "jacobian_rel_to_max": rel_to_max(jac, J64),
            "images_rel_to_max": rel_to_max(images(jac.float()), img64),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
