"""The FEM cells: subjects' breathing cycles through eitx_torch's simulation.

Traffic (``traffic/<name>.json``): a closed loop of one caller over a pool
of ``pool`` thorax subjects made from the seed, ``batch`` subjects a call.
``mode`` "factory" calls ``simulate_eit_monitoring_subjects`` on batches of
the pool in turn (the dataset factory's grouping); "request" calls
``simulate_eit_monitoring`` on one subject at a time (one service
request's simulation stage).

The comparison holds every answer of the window, at a set of frames drawn
from the seed, to the float64 reference (``reference/fem.py``): the worst
gap of the voltages and of their breathing signal (each frame less the
first), each over its own scale.
"""

from __future__ import annotations

import numpy as np
import torch

from ..inputs.thorax import subject_pool
from ..lib import flops
from ..reference import fem as ref

# what a number reads when the window produced nothing to compare
NO_ANSWER = 1e30


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def subject_sizes(mesh: dict, lung_class: int):
    """(nodes, elements, lung rank) of a subject as the setup sees it: the
    nodes its elements use, and its lung nodes less the grounded node 0."""
    tris = np.asarray(mesh["TRIANGLES"])
    used, inv = np.unique(tris, return_inverse=True)
    inv = inv.reshape(tris.shape)
    lung = np.unique(inv[np.asarray(mesh["CLASS"]) == lung_class])
    return int(used.size), int(tris.shape[0]), int((lung != 0).sum())


class Driver:
    """``variant``: ``sound``; ``tf32``, the control (products in TF32);
    ``answer_altered`` (each call's first answer scaled by 1.01);
    ``half_batch`` (half of each batch simulated, its answers copied into
    the other half)."""

    def __init__(self, cell, seed: int, device: torch.device,
                 variant: str = "sound", trace: bool = False):
        from eitx_torch.core.config import SimulationConfig
        from eitx_torch.fem import forward

        cfg, traffic = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, int(seed), device
        self.variant = variant
        self.forward = forward
        self.sim = SimulationConfig(**cfg["simulation"])
        self.classes = {int(k): v for k, v in cfg["classes"].items()}
        lung = {v: k for k, v in self.classes.items()}["lung"]
        self.pool = subject_pool(cfg["geometry"], traffic["jitter"],
                                 traffic["pool"], seed)
        self.sizes = [subject_sizes(m, lung) for m in self.pool]
        buckets = {(_round_up(n, self.sim.pad_nodes_to),
                    _round_up(e, self.sim.pad_elems_to))
                   for n, e, _ in self.sizes}
        if len(buckets) != 1:
            raise ValueError(f"the pool splits across padding buckets "
                             f"{sorted(buckets)}")
        self.mode, self.batch = traffic["mode"], int(traffic["batch"])
        if self.mode == "factory":
            self.calls = [list(range(i, i + self.batch))
                          for i in range(0, len(self.pool), self.batch)]
        else:
            self.calls = [[i] for i in range(len(self.pool))]
        if variant == "tf32":  # the control: products in TF32
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        self.n_calls = 0
        self.answers = []  # (pool index, voltages) of every completed call
        for _ in range(int(traffic["warmup_calls"])):
            self.step()
        self.answers.clear()

    # -- the window's call ---------------------------------------------------
    def _simulate(self, idx):
        meshes = [self.pool[i] for i in idx]
        dev = self.device
        if self.mode == "factory":
            run = meshes[:len(meshes) // 2] if self.variant == "half_batch" \
                else meshes
            out = [v for v, _ in
                   self.forward.simulate_eit_monitoring_subjects(
                       run, self.sim, device=dev)]
            while len(out) < len(meshes):
                out.append(out[len(out) - len(run)])
            return out
        return [self.forward.simulate_eit_monitoring(meshes[0], self.sim,
                                                     device=dev)[0]]

    def step(self) -> int:
        idx = self.calls[self.n_calls % len(self.calls)]
        self.n_calls += 1
        out = self._simulate(idx)
        if self.variant == "answer_altered":
            out[0] = out[0] * np.float32(1.01)
        self.answers.extend(zip(idx, out))
        return len(idx)

    # -- the traced run ------------------------------------------------------
    def span_targets(self):
        from eitx_torch.fem import spectral
        from eitx_torch.fem.assembly import ClassStiffness

        f = self.forward
        return [
            (f, "prepare_mesh_info", "bench.fem.prep", "host"),
            (f, "compact_mesh_nodes", "bench.fem.prep", "host"),
            (f, "_electrodes", "bench.fem.prep", "host"),
            (ClassStiffness, "build", "bench.fem.assembly", "device"),
            (spectral.LowRankSpectralSolver, "build", "bench.fem.setup",
             "device"),
            (spectral.LowRankSpectralSolver, "build_batch",
             "bench.fem.setup", "device"),
        ]

    def layer_context(self) -> dict:
        """What the readers need beyond the trace: the traced answers'
        FLOPs and bytes by the subject's own sizes."""
        s = self.sim
        n_exc = s.n_electrodes
        n_read = sum(len(r) for r in ref.adjacent_protocol(n_exc)[1])
        setup_f = setup_b = solve_f = 0.0
        for i, _ in self.answers:
            n, _, m = self.sizes[i]
            setup_f += flops.lowrank_setup_flops(n, m, n_exc)
            setup_b += flops.lowrank_setup_bytes(n, m, n_exc, s.n_electrodes)
            solve_f += flops.lowrank_solve_flops(s.n_points, m, n_read)
        return {"subjects": len(self.answers), "setup_flops": setup_f,
                "setup_bytes": setup_b, "solve_flops": solve_f}

    # -- the comparison ------------------------------------------------------
    def release(self) -> None:
        """Free what the program holds on the card before the reference."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """{number: value} over every answer of the window, each at the
        same frames: the first, the middle (full inspiration) and
        ``check_frames`` - 2 more drawn from the seed."""
        if not self.answers:
            return {"v_of_scale": NO_ANSWER, "dv_of_scale": NO_ANSWER}
        t = self.sim.n_points
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 7]))
        rest = np.setdiff1d(np.arange(1, t), [t // 2])
        frames = np.sort(np.concatenate([[0, t // 2], rng.choice(
            rest, size=int(self.cell.spec["check_frames"]) - 2,
            replace=False)]))
        simd = dict(self.cell.config["simulation"],
                    **self.cell.config["reference_only"])
        mats = self.cell.config["materials"]
        refs, v_gap, dv_gap = {}, 0.0, 0.0
        for i, v in self.answers:
            if i not in refs:
                refs[i] = ref.simulate(self.pool[i], simd, mats, self.classes,
                                       frames)
            r = refs[i]
            v = np.asarray(v, np.float64).reshape(t, -1)[frames]
            v_gap = max(v_gap, np.abs(v - r).max() / np.abs(r).max())
            d = r - r[:1]
            dv_gap = max(dv_gap, np.abs((v - v[:1]) - d).max()
                         / np.abs(d).max())
        return {"v_of_scale": float(v_gap), "dv_of_scale": float(dv_gap)}
