"""Does Gauss-Newton fit the tissue-table background from its homogeneous
start, in eitx and in the port? On the real slice meshed at the serving
lc 7, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_gauss_newton_start.py [--n-iter 8]

The measured voltages are the float64 oracle's for the tissue table's
per-element conductivities (the background ``monitoring_linearization``
gives) and for the same with +50 % in the left lung. Both packages run
``gauss_newton_absolute`` (lam 1e-2) from the best-fitting homogeneous
conductivity on the same numpy inputs. Prints one JSON line per case and
package: the squared residual of every iteration and the distance of the
result from the true conductivities. Not collected by pytest.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from eitx.fem.inverse import gauss_newton_absolute as eitx_gn
    from eitx_torch.fem import inverse
    from eitx_torch.fem.oracle import forward_solve_oracle
    from eitx_torch.mesh import create_mesh

    p = argparse.ArgumentParser()
    p.add_argument("--n-iter", type=int, default=8)
    args = p.parse_args()
    with open(os.path.join(ROOT, "tests", "data",
                           "real_slice_polygons.txt")) as fh:
        polygons = [ln.strip() for ln in fh
                    if ln.strip() and not ln.startswith("#")]
    _, mesh = create_mesh(["1", "1"], polygons, 7, 1.3, 1,
                          show_meshing_result_method="no", device="cpu")
    info, sigma_ref, el, proto = inverse.monitoring_linearization(mesh)
    nodes, tris = info.node, info.element
    lung = info.cond == 2
    cent = nodes[tris].mean(axis=1)
    left = lung & (cent[:, 0] < np.median(cent[lung, 0]))
    inclusion = sigma_ref.copy()
    inclusion[left] *= 1.5
    for case, sigma_true in (("tissue_table", sigma_ref),
                             ("tissue_table_lung_plus_50", inclusion)):
        v = forward_solve_oracle(nodes, tris, sigma_true, el, proto.ex_mat,
                                 proto.meas_mat)
        gn = (nodes, tris, v, el, proto.ex_mat, proto.meas_mat)
        runs = {
            "eitx": lambda: eitx_gn(*gn, n_iter=args.n_iter),
            "eitx_torch": lambda: inverse.gauss_newton_absolute(
                *gn, n_iter=args.n_iter, device="cpu"),
        }
        for package, run in runs.items():
            try:
                sigma, res = (np.asarray(a, np.float64) for a in run())
            except Exception as e:  # the port raises where eitx gives NaN
                print(json.dumps({"case": case, "package": package,
                                  "error": f"{type(e).__name__}: {e}"}))
                continue
            print(json.dumps({
                "case": case, "package": package,
                "nodes": int(nodes.shape[0]), "elements": int(tris.shape[0]),
                "squared_residuals": [float(r) for r in res],
                "residual_grew": bool(res[-1] > res[0]),
                "sigma_rel_error": float(np.abs(sigma - sigma_true).max()
                                         / np.abs(sigma_true).max()),
                "sigma_finite": bool(np.isfinite(sigma).all()),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
