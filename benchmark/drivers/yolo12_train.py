"""The YOLO12 training cell: ``fit``'s loop of eitx_torch's trainer with
``TrainConfig.arch`` "yolo12".

As ``drivers/yolo_train.py``, whose window, spans and comparison numbers
it keeps: one ``Trainer`` with the benchmark's initial parameters
(``inputs/weights.py``, then every A2C2f ``gamma`` at 0.01), one ``EMA``
and one ``device_batches`` stream of the phantom store, driven through
the traffic's warm steps; the comparison runs the same steps on the plain
reference of ``reference/yolo12`` from the same parameters and store.

One number differs from that driver's: ``delta_gap`` and ``ema_gap`` are
the change after the warm steps as one vector over the live leaves
(``pooled_gap``), not the worst leaf's norm. The reference is independent,
so rounding can flip a TAL or mask assignment, which moves a few of the
head's leaves (one seed in 24 read 3.9 % of a leaf there), while TF32
moves every leaf a little (6.6-6.9 % in the worst leaf): the worst leaf
tells the two apart by 1.7x, the pooled difference by 7.8x (0.071 against
0.55; PERF.md gives the readings).
"""

from __future__ import annotations

import numpy as np
import torch

from ..inputs.phantoms import phantom_store
from ..inputs.weights import initial_state
from ..lib.area_attn import network_area_attn
from ..lib.flops import TrainFlops
from . import yolo_train
from .yolo_train import _B1, DEAD_LEAF, _clone, _norms, worst_leaf_gap

GAMMA0 = 0.01  # A2C2f's layer scale at initialisation (ultralytics')


def start_state(params: dict, stats: dict, seed: int, device):
    """``initial_state`` of these shapes, with every ``gamma`` (which it
    sets to 0, a 1-D vector not named weight) at ``GAMMA0``."""
    params, stats = initial_state(params, stats, seed, device)
    for n, t in params.items():
        if n.endswith("gamma"):
            t.fill_(GAMMA0)
    return params, stats


def pooled_gap(prog: dict, ref: dict, leaves) -> float:
    """norm(prog - ref) / norm(ref), each leaf of ``leaves`` one block of
    a single vector."""
    num = sum(float(torch.linalg.vector_norm((prog[n] - ref[n]).detach()
                                              .double())) ** 2 for n in leaves)
    den = sum(float(torch.linalg.vector_norm(ref[n].detach().double())) ** 2
              for n in leaves)
    return (num / max(den, 1e-300)) ** 0.5


def plant(model, variant: str) -> None:
    """The faults of the program's attention: ``area_whole``, layer 6
    (P4) attends over the whole map, not in its stripes; ``no_pe``, every
    position perceiver's output is multiplied by 0."""
    for name, m in model.named_modules():
        if type(m).__name__ != "AAttn":
            continue
        if variant == "area_whole" and name.startswith("model.6."):
            m.area = 1
        elif variant == "no_pe":
            m.pe.forward = (lambda v, f=m.pe.forward: f(v) * 0.0)


class Driver(yolo_train.Driver):
    """``variant``: those of ``drivers/yolo_train.py`` (``sound``,
    ``tf32``, ``state_unchanged``, ``half_batch``, ``batch_altered``) and
    ``area_whole``, ``no_pe`` (``plant``)."""

    def __init__(self, cell, seed: int, device: torch.device,
                 variant: str = "sound", trace: bool = False):
        from eitx_torch.train.data import device_batches
        from eitx_torch.train.trainer import (EMA, OptState, TrainConfig,
                                              Trainer, TrainState)

        cfg, tr = cell.config, cell.traffic
        # first, so that a program without ``arch`` fails at once
        train_cfg = TrainConfig(**cfg["train"])
        self.cell, self.seed, self.device = cell, int(seed), device
        self.variant = variant
        self.batch = int(cfg["batch"])
        if variant == "tf32":  # the control: convolutions and products in TF32
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        self.store = phantom_store(
            tr["store"], cfg["train"]["imgsz"], cfg["train"]["max_instances"],
            cfg["mask_res"], tr["instances"], seed, device)
        self.stream_args = dict(flip_h_prob=tr["flip_h_prob"],
                                flip_v_prob=tr["flip_v_prob"],
                                mosaic_prob=tr["mosaic_prob"])
        self.trainer = Trainer(train_cfg, device=device)
        plant(self.trainer.model, variant)
        st = self.trainer.state
        params, stats = start_state(st.params, st.batch_stats, seed, device)
        zeros = {n: torch.zeros_like(p) for n, p in params.items()}
        self.trainer.state = TrainState(
            params=params, batch_stats=stats,
            opt_state=OptState(mu=zeros, nu=_clone(zeros), count=0), step=0)
        self.ema = EMA(self.trainer.local_params(), cfg["ema_decay"])
        self.stream = device_batches(self.store, self.batch, seed=seed,
                                     device=device, **self.stream_args)
        self.theta0 = _clone(params)
        self.step_flops = 0.0
        self.attn = network_area_attn(cfg, self.batch, cfg["train"]["imgsz"])
        self.warm = {"batches": [], "losses": []}
        for k in range(int(tr["warm_steps"])):
            if k == 0 and trace:
                with TrainFlops() as count:
                    self.step(record=True)
                self.step_flops = count.flops
            else:
                self.step(record=True)
            if k == 0:
                self.warm["mu1"] = _clone(self.trainer.opt_state.mu)
        self.warm["theta3"] = _clone(self.trainer.local_params())
        self.warm["ema3"] = _clone(self.ema.params)

    def layer_context(self) -> dict:
        return {"step_flops": self.step_flops,
                "area_attn_flops": self.attn[0],
                "area_attn_bytes": self.attn[1]}

    def check(self) -> dict:
        from ..reference.yolo import data as ref_data
        from ..reference.yolo12 import trainer as ref_tr

        # the reference runs in float32 whatever the control switched on
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.cell.config
        rt = ref_tr.Trainer(ref_tr.TrainConfig(**cfg["train"]),
                            device=self.device)
        st = rt.state
        params, stats = start_state(st.params, st.batch_stats, self.seed,
                                    self.device)
        zeros = {n: torch.zeros_like(p) for n, p in params.items()}
        rt.state = ref_tr.TrainState(
            params=params, batch_stats=stats,
            opt_state=ref_tr.OptState(mu=zeros, nu=_clone(zeros), count=0),
            step=0)
        ema = ref_tr.EMA(rt.local_params(), cfg["ema_decay"])
        stream = ref_data.device_batches(self.store, self.batch,
                                         seed=self.seed, device=self.device,
                                         **self.stream_args)
        theta0 = _clone(params)
        batch_gap, loss_rel, mu1 = 0.0, 0.0, None
        for k, (pb, pl) in enumerate(zip(self.warm["batches"],
                                         self.warm["losses"])):
            rb = next(stream)
            batch_gap = max([batch_gap] + [
                float((pb[key].double() - rb[key].double()).abs().max())
                for key in rb])
            rl = rt.train_step(rb, device_metrics=True)["loss"]
            ema.update(rt.local_params())
            loss_rel = max(loss_rel, abs(float(pl) - float(rl))
                           / max(abs(float(rl)), 1e-30))
            if k == 0:
                mu1 = _clone(rt.opt_state.mu)
        if mu1 is None:
            return {k: 1e30 for k in self.cell.spec["limits"]}
        names = list(mu1)
        g_ref = {n: mu1[n] / (1.0 - _B1) for n in names}
        g_prog = {n: self.warm["mu1"][n] / (1.0 - _B1) for n in names}
        gn = _norms(g_ref)
        med = float(np.median(list(gn.values())))
        live = [n for n in names if gn[n] >= DEAD_LEAF * med]
        d_ref = {n: rt.local_params()[n] - theta0[n] for n in names}
        d_prog = {n: self.warm["theta3"][n] - self.theta0[n] for n in names}
        e_ref = {n: ema.params[n] - theta0[n] for n in names}
        e_prog = {n: self.warm["ema3"][n] - self.theta0[n] for n in names}
        return {"batch_gap": batch_gap, "loss_rel": loss_rel,
                "grad_gap": worst_leaf_gap(g_prog, g_ref, names),
                "delta_gap": pooled_gap(d_prog, d_ref, live),
                "ema_gap": pooled_gap(e_prog, e_ref, live)}
