"""Stage-by-stage profile of the low-rank spectral EIT setup.

Port of eitx/scripts/profile_setup.py, staged on the port's own setup:
``LowRankSpectralSolver.build`` / ``build_batch`` (fem/spectral.py) and
its ``_lowrank_core``. Every stage is timed alone for one subject (a
stack of one, as ``build`` runs it) and for a stack of ``--batch``
subjects (as ``build_batch`` runs it), so the dominant stage is named by
measurement:

  s0_kbase            K_base = sum_c sig_c K_c + diag fix
  s1_cholesky_N       L = chol(K_base)
  s2_lung_block_gather  the lung block Kl_s of the lung pencil
  s3_trisolve_L       L^-1 [S, B]  (P and C0)
  s4_gram_PtP         G = P^T P (+ unit dead slots)
  s5_cholesky_r       C = chol(G)
  s6_project          C^T Kl_s C
  s7_eigh_r           the single r x r eigh
  s8_form_Q           Q = P C^-T Z
  s9_readout          L^-T [Q, C0] at the electrodes, yq = Q^T C0
  build               the whole setup (``build`` / ``build_batch``)

The subjects are the synthetic thorax of the repository's bench (six
ellipses at lc 7, radii jittered by 3 % from the seed) meshed by the
port. Times: CUDA events around ``repeats`` calls after a warm-up, the
median, on the card; the host's clock on the CPU.

Usage: python -m eitx_torch.scripts.profile_setup [--batch 8] [--repeats 5]
           [--report f.json] [--device cuda]
Prints one JSON line a stage as it is timed, then the whole result:
stage -> {single_ms, batch_ms, batch_per_subject_ms}.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def thorax_mesh(lc: float = 7.0, jitter: float = 0.0, seed: int = 0,
                device="cuda"):
    """The bench's synthetic thorax mesh (bench.py ``build_thorax_mesh``);
    ``jitter`` scales the anatomy (same lc, so the padding buckets of a
    batch of subjects coincide)."""
    from ..mesh import create_mesh

    rng = np.random.default_rng(seed)

    def j():
        return 1.0 + rng.uniform(-jitter, jitter) if jitter else 1.0

    def ellipse(cid, cx, cy, rx, ry, n=80):
        th = np.linspace(0, 2 * np.pi, n, endpoint=False)
        pts = np.stack(
            [cx + rx * j() * np.cos(th), cy + ry * j() * np.sin(th)], 1
        )
        return f"{cid} " + " ".join(f"{x:.1f} {y:.1f}" for x, y in pts)

    polygons = [
        ellipse(4, 256, 256, 200, 150, 90),
        ellipse(3, 256, 256, 192, 142, 70),
        ellipse(1, 256, 256, 170, 125, 70),
        ellipse(2, 175, 250, 55, 75, 40),
        ellipse(2, 337, 250, 55, 75, 40),
        ellipse(0, 256, 330, 22, 18, 24),
    ]
    _, mesh = create_mesh(["0.75", "0.75"], polygons, lc=lc,
                          show_meshing_result_method="no", device=device)
    return mesh


def _stage_inputs(css, els, sigma0, lung, a0, proto, rank_bucket=256):
    """The stack's inputs of ``_lowrank_core``, as ``_build_stack`` makes
    them: k_stack, diag, sigma, alpha0s, lung indices, masks, selector,
    injection block, electrode rows."""
    from ..fem.solver import _index, _rhs_matrix, _values
    from ..fem.spectral import (
        _lung_subspace_indices,
        _selector,
        _stack_subjects,
    )

    k_stack, d_stack, ref, el_stack = _stack_subjects(css, els)
    dev, dt = k_stack.device, k_stack.dtype
    n = k_stack.shape[-1]
    pairs = [_lung_subspace_indices(c, lung, rank_bucket) for c in css]
    r = max(p[0].shape[0] for p in pairs)
    idxs = np.stack([np.pad(p[0], (0, r - p[0].shape[0])) for p in pairs])
    masks = np.stack([np.pad(p[1], (0, r - p[1].shape[0])) for p in pairs])
    sel = np.stack([_selector(i, m, n) for i, m in zip(idxs, masks)])
    rhs = torch.stack([_rhs_matrix(e, proto.ex_mat, n, dt, dev)
                       for e in els])
    rhs[:, ref, :] = 0.0
    return dict(k=k_stack, extra=torch.diag_embed(d_stack),
                sigma=_values(sigma0, dt, dev),
                a0=_values([a0] * len(css), dt, dev),
                idx=_index(idxs, dev), mask=_values(masks, dt, dev),
                S=_values(sel, dt, dev), rhs=rhs, rows=el_stack)


def _stages(x, lung):
    """The stages of ``_lowrank_core`` on stack inputs ``x``: name ->
    (fn, args), each stage fed by the previous ones' results."""
    from ..fem.spectral import _base_matrices, _cholesky, _rows

    def kbase(k, extra, sig, a0):
        return _base_matrices(k, extra, sig, lung, a0)

    def gather(Kl, idx, mask):
        bi = torch.arange(Kl.shape[0], device=Kl.device)[:, None, None]
        return Kl[bi, idx[:, :, None], idx[:, None, :]] * (
            mask[:, :, None] * mask[:, None, :])

    def trisolve(L, S, rhs):
        return torch.linalg.solve_triangular(L, torch.cat([S, rhs], -1),
                                             upper=False)

    def gram(P, mask):
        G = P.mT @ P + torch.diag_embed(1.0 - mask)
        return 0.5 * (G + G.mT)

    def project(C, Kl_s):
        Bt = C.mT @ (Kl_s @ C)
        return 0.5 * (Bt + Bt.mT)

    def form_q(P, C, s2, Z):
        eps = torch.clamp(s2.amax(dim=-1, keepdim=True), min=0.0) * 1e-7
        live = s2 > eps
        Y = torch.linalg.solve_triangular(
            C.mT, torch.where(live[:, None, :], Z, torch.zeros_like(Z)),
            upper=True)
        return P @ Y

    def readout(L, Q, C0, rows):
        W = _rows(torch.linalg.solve_triangular(
            L.mT, torch.cat([Q, C0], -1), upper=True), rows)
        return W, Q.mT @ C0

    r = x["idx"].shape[-1]
    Kl = x["k"][:, lung]
    K = kbase(x["k"], x["extra"], x["sigma"], x["a0"])
    L = _cholesky(K)
    Kl_s = gather(Kl, x["idx"], x["mask"])
    C_all = trisolve(L, x["S"], x["rhs"])
    P, C0 = C_all[..., :r], C_all[..., r:]
    G = gram(P, x["mask"])
    C = _cholesky(G)
    Bt = project(C, Kl_s)
    s2, Z = torch.linalg.eigh(Bt)
    Q = form_q(P, C, s2, Z)
    return {
        "s0_kbase": (kbase, (x["k"], x["extra"], x["sigma"], x["a0"])),
        "s1_cholesky_N": (_cholesky, (K,)),
        "s2_lung_block_gather": (gather, (Kl, x["idx"], x["mask"])),
        "s3_trisolve_L": (trisolve, (L, x["S"], x["rhs"])),
        "s4_gram_PtP": (gram, (P, x["mask"])),
        "s5_cholesky_r": (_cholesky, (G,)),
        "s6_project": (project, (C, Kl_s)),
        "s7_eigh_r": (torch.linalg.eigh, (Bt,)),
        "s8_form_Q": (form_q, (P, C, s2, Z)),
        "s9_readout": (readout, (L, Q, C0, x["rows"])),
    }


def profile(batch: int = 8, repeats: int = 5, device="cuda") -> dict:
    from ..core.config import ClassMap
    from ..core.device import resolve_device
    from ..core.timing import call_ms
    from ..fem import ClassStiffness, LowRankSpectralSolver
    from ..fem.electrodes import place_electrodes_equal_spacing
    from ..fem.forward import (
        build_sigma_frames,
        compact_mesh_nodes,
        prepare_mesh_info,
    )
    from ..fem.protocol import create_protocol
    from ..physio.materials import (
        generate_material_tables,
        tissue_conductivities,
    )
    from ..physio.spirometry import conductivity_schedule

    dev = resolve_device(device)
    B = batch
    classes = ClassMap()
    mats = generate_material_tables()
    _, condspir = conductivity_schedule(12, 100, 5e4, mats)
    base = tissue_conductivities(mats, 5e4, classes.id_to_name())
    sigma = build_sigma_frames(condspir, base, classes)
    lung = classes.name_to_id()["lung"]
    a0 = float(np.mean(sigma[:, lung]))
    proto = create_protocol(16, 1, 1, "std")
    infos = [compact_mesh_nodes(prepare_mesh_info(
        thorax_mesh(lc=7.0, jitter=0.03, seed=s, device=dev), classes))
        for s in range(B)]
    els = [place_electrodes_equal_spacing(i.node, i.element, 16,
                                          starting_angle=np.pi)
           for i in infos]
    css = [ClassStiffness.build(i.node, i.element, i.cond, n_classes=5,
                                pad_nodes_to=512, pad_elems_to=2048,
                                device=dev) for i in infos]
    if len({tuple(c.k_class.shape) for c in css}) != 1:
        raise RuntimeError("the subjects fell into several padding buckets")

    def timed(fn, *a):
        return float(np.median(call_ms(fn, *a, repeats=repeats, device=dev)))

    single_x = _stage_inputs(css[:1], els[:1], sigma[0], lung, a0, proto)
    batch_x = _stage_inputs(css, els, sigma[0], lung, a0, proto)
    out = {"n_nodes_padded": int(css[0].n_nodes),
           "rank": int(single_x["idx"].shape[-1]), "batch": B,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "timer": "cuda events" if dev.type == "cuda" else "host clock"}
    with torch.inference_mode():
        single = _stages(single_x, lung)
        batched = _stages(batch_x, lung)
        for name, (fn, a) in single.items():
            out[name] = {"single_ms": timed(fn, *a)}
            fn_b, a_b = batched[name]
            ms = timed(fn_b, *a_b)
            out[name]["batch_ms"] = ms
            out[name]["batch_per_subject_ms"] = ms / B
            print(json.dumps({name: out[name]}), flush=True)
        sig_c = sigma[0]
        build = {"single_ms": timed(lambda: LowRankSpectralSolver.build(
            css[0], sig_c, lung, els[0], proto.ex_mat, proto.meas_mat, a0))}
        ms = timed(lambda: LowRankSpectralSolver.build_batch(
            css, sig_c, lung, els, proto.ex_mat, proto.meas_mat, [a0] * B))
        build.update(batch_ms=ms, batch_per_subject_ms=ms / B)
        out["build"] = build
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--report", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = profile(args.batch, args.repeats, args.device)
    print(json.dumps(out, indent=1))
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
