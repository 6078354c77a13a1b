"""Which call of the direct batched solve rounds by its batch size?

    python tests/torch_batch_invariance.py [--frames 100] [--block 25]

On the card, ``fem.solver.forward_solve_batched``'s stages run on all
``--frames`` frames of the serving schedule (an lc-7 thorax of
chip_smoke.py's factory) and on the first ``--block`` of them alone, as a
rank of a sharded run gets them; each stage is fed the same inputs both
ways, and its first ``--block`` outputs are compared (largest difference
of the stage's scale; 0 means equal bits). Then the whole solve on
blocks of frames, solved in stacks of the whole call's size
(``solve_frames_in_stacks``) as a rank's, and alone, against the same
frames of one call over all; the two triangular solves that
``cholesky_solve`` stands for; the times of each; candidates for the
solves (stacks of a fixed size, one frame at a time, a block moved into a
stack of all T); the segmenter's labels of 4 images alone, and padded to
a call of 16, against the same 4 inside a call of 16. Prints one JSON
object.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _diff(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--block", type=int, default=25)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import chip_smoke as cs
    from eitx_torch.core.config import ModelConfig, SimulationConfig
    from eitx_torch.fem import forward_solve_batched
    from eitx_torch.fem.solver import (
        _index,
        _measure,
        _rhs_matrix,
        _values,
        solve_frames_in_stacks,
        solve_stack_frames,
    )
    from eitx_torch.mesh import create_mesh
    from eitx_torch.models.yolo.infer import TissueSegmenter

    dev = torch.device(args.device)
    _, m = create_mesh(["0.75", "0.75"], cs.thorax_polygons(0), lc=7.0,
                       show_meshing_result_method="no", device=dev)
    _, sigma, proto, el, c = cs.subject_system(m, SimulationConfig(), dev)
    sigma = sigma[:args.frames]
    k = args.block
    out = {"device": (cs.gpu_name_and_limit() if dev.type == "cuda"
                      else "cpu"), "frames": int(sigma.shape[0]), "block": k,
           "nodes_padded": int(c.n_nodes)}

    sig = _values(sigma, c.k_class.dtype, dev)
    scale = sig.mean(dim=1, keepdim=True)
    stages = {}
    K = c.system_matrices(sig / scale)
    stages["system_matrices"] = _diff(c.system_matrices(sig[:k] / scale[:k]),
                                      K[:k])
    B = _rhs_matrix(el, proto.ex_mat, c.n_nodes, K.dtype, dev)
    B[c.ref_node, :] = 0.0
    L = torch.linalg.cholesky(K)
    stages["cholesky"] = _diff(torch.linalg.cholesky(K[:k]), L[:k])
    U = torch.cholesky_solve(B.expand(K.shape[0], -1, -1), L)
    stages["cholesky_solve"] = _diff(
        torch.cholesky_solve(B.expand(k, -1, -1), L[:k]), U[:k])
    KU = K @ U
    stages["bmm_K_U"] = _diff(K[:k] @ U[:k], KU[:k])
    R = B - KU
    D = torch.cholesky_solve(R, L)
    stages["refinement_solve"] = _diff(torch.cholesky_solve(R[:k], L[:k]),
                                       D[:k])
    U2 = U + D
    v = _measure(U2[:, _index(el, dev), :], _index(proto.meas_mat, dev))
    stages["measure"] = _diff(
        _measure(U2[:k][:, _index(el, dev), :], _index(proto.meas_mat, dev)),
        v[:k])
    out["stages_rel_of_scale"] = stages
    whole = forward_solve_batched(c, sigma, el, proto.ex_mat, proto.meas_mat)
    T = sigma.shape[0]
    out["forward_solve_batched_rel_of_scale"] = {
        f"{lo}:{hi}": _diff(solve_frames_in_stacks(
            c, _values(sigma[lo:hi], c.k_class.dtype, dev), el,
            proto.ex_mat, proto.meas_mat, solve_stack_frames(c, T)),
            whole[lo:hi])
        for lo, hi in ((0, 1), (0, 2), (1, 3), (0, k), (k, 2 * k), (T - 1, T))}
    out["forward_solve_batched_alone_rel_of_scale"] = _diff(
        forward_solve_batched(c, sigma[:k], el, proto.ex_mat,
                              proto.meas_mat), whole[:k])

    # the two triangular solves that cholesky_solve stands for
    def trsm(rhs, fac):
        y = torch.linalg.solve_triangular(fac, rhs, upper=False)
        return torch.linalg.solve_triangular(fac.mT, y, upper=True)

    Bx = B.expand(K.shape[0], -1, -1)
    stages["trsm_pair"] = _diff(trsm(Bx[:k], L[:k]), trsm(Bx, L)[:k])
    stages["trsm_pair_vs_cholesky_solve"] = _diff(trsm(Bx, L), U)
    out["ms"] = {
        "forward_solve_batched": _ms(lambda: forward_solve_batched(
            c, sigma, el, proto.ex_mat, proto.meas_mat), dev),
        "cholesky_solve": _ms(lambda: torch.cholesky_solve(Bx, L), dev),
        "trsm_pair": _ms(lambda: trsm(Bx, L), dev)}

    # the solves' candidates that keep a frame's bits whatever the stack:
    # stacks of f frames (the last padded), or one frame at a time
    def stacked(solve, fac, f):
        T = fac.shape[0]
        parts = []
        for t in range(0, T, f):
            part = fac[t:t + f]
            if part.shape[0] < f:
                part = torch.cat([part, part[-1:].expand(
                    f - part.shape[0], -1, -1)])
            parts.append(solve(B.expand(f, -1, -1), part))
        return torch.cat(parts)[:T]

    def per_frame(solve, fac):
        return torch.stack([solve(B, fac[t]) for t in range(fac.shape[0])])

    cands = {f"cholesky_solve_stacks_of_{f}": (
        lambda fac, f=f: stacked(lambda b, x: torch.cholesky_solve(b, x),
                                 fac, f)) for f in (16, 32, 128)}
    cands["trsm_pair_stacks_of_16"] = lambda fac: stacked(trsm, fac, 16)
    cands["trsm_pair_per_frame"] = lambda fac: per_frame(trsm, fac)
    # frames k .. 2k placed first in a stack of all T frames (the rest
    # copies of the last), as a rank of a sharded run would pad its block
    def placed(fac, lo, hi):
        part = torch.cat([fac[lo:hi], fac[hi - 1:hi].expand(
            fac.shape[0] - (hi - lo), -1, -1)])
        return torch.cholesky_solve(Bx, part)[:hi - lo]

    whole_solve = torch.cholesky_solve(Bx, L)
    out["cholesky_solve_moved_in_a_stack_of_T_rel_of_scale"] = {
        f"{lo}:{hi}": _diff(placed(L, lo, hi), whole_solve[lo:hi])
        for lo, hi in ((0, k), (k, 2 * k), (3 * k, 4 * k))}
    out["ms"]["cholesky_solve_stack_of_T_placed"] = _ms(
        lambda: placed(L, k, 2 * k), dev)
    out["solve_candidates"] = {
        name: dict(rel_of_scale=_diff(fn(L[:k]), fn(L)[:k]),
                   ms=_ms(lambda: fn(L), dev))
        for name, fn in cands.items()}

    mc = ModelConfig()
    seg = TissueSegmenter(512, weights=os.path.join(
        ROOT, "weights", "tissue_n_512.msgpack"), variant="n",
        conf=mc.axial_conf_per_class, max_det=mc.max_detections,
        tta_fill=mc.axial_tta_fill, dtype=mc.dtype, device=dev)
    image = np.load(os.path.join(ROOT, "tests", "data",
                                 "torch_smoke_512.npz"))["image"]
    imgs = cs._seg_variants(image, 16)
    with torch.inference_mode():
        x = torch.from_numpy(imgs).to(dev)
        all16 = seg._segment_labels_device(x, False)
        four = seg._segment_labels_device(x[:4], False)
        # four images padded to a call of 16 by repeating the last
        padded = seg._segment_labels_device(
            torch.cat([x[:4], x[3:4].expand(12, -1, -1)]), False)
        raw16 = seg.model(_prep(x, seg))
        raw4 = seg.model(_prep(x[:4], seg))
    out["labels_4_vs_16_agreement"] = float((four == all16[:4]).float(
    ).mean())
    out["labels_4_padded_to_16_equal"] = bool(torch.equal(padded[:4],
                                                          all16[:4]))
    out["network_proto_4_vs_16_rel_of_scale"] = _diff(
        raw4["proto"].float(), raw16["proto"][:4].float())
    print(json.dumps(out), flush=True)
    return out


def _ms(fn, dev) -> float:
    """Median ms of 5 calls after one, between CUDA events (the CPU: the
    host's clock)."""
    from eitx_torch.core.timing import call_ms

    return float(np.median(call_ms(fn, repeats=5, device=dev)))


def _prep(x, seg):
    from eitx_torch.models.yolo.infer import _letterbox

    return _letterbox(x, seg.imgsz, seg.compute_dtype)


if __name__ == "__main__":
    main()
