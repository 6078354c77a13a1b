"""The training cell: ``fit``'s loop of eitx_torch's trainer.

Set-up builds one ``Trainer`` with the benchmark's initial parameters
(``inputs/weights.py``), one ``EMA`` and one ``device_batches`` stream of
the benchmark's phantom store (``inputs/phantoms.py``), and drives them
through ``warm_steps`` steps of the window's own call: ``next(stream)``,
``train_step``, ``EMA.update``. The same objects then serve the window.

The comparison follows those first three steps with the frozen reference
(``reference/yolo``) from the same parameters and store: each step's batch
(exact), each step's loss, the first gradient as the optimizer got it
(AdamW's first moment after one step over 1 - b1), the parameters' change
after three steps and the EMA's, the last three by the worst leaf: the gap
between the two norms over the reference's norm of that leaf or of the
median leaf, whichever is larger. The change and the EMA leave out the
leaves whose first gradient is under a thousandth of the median leaf's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..inputs.phantoms import phantom_store
from ..inputs.weights import initial_state
from ..lib.flops import TrainFlops

_B1 = 0.9
# a leaf's first gradient under this share of the median leaf's is
# round-off (a key's bias under softmax): its change is not compared
DEAD_LEAF = 1e-3


def _norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.detach().double())) for n, t in
            tensors.items()}


def worst_leaf_gap(prog: dict, ref: dict, leaves) -> float:
    """max over ``leaves`` of |norm(prog) - norm(ref)| / max(norm(ref),
    the median leaf's norm(ref))."""
    p, r = _norms({n: prog[n] for n in leaves}), _norms(
        {n: ref[n] for n in leaves})
    med = float(np.median(list(r.values())))
    return max(abs(p[n] - r[n]) / max(r[n], med, 1e-30) for n in leaves)


def _clone(d: dict) -> dict:
    return {k: v.detach().clone() for k, v in d.items()}


class Driver:
    """``variant``: ``sound``; ``tf32``, the control (convolutions and
    products in TF32); ``state_unchanged`` (a step that updates nothing);
    ``half_batch`` (each step on the first half of its batch);
    ``batch_altered`` (each batch's first two samples swapped)."""

    def __init__(self, cell, seed: int, device: torch.device,
                 variant: str = "sound", trace: bool = False):
        from eitx_torch.train.data import device_batches
        from eitx_torch.train.trainer import (EMA, OptState, TrainConfig,
                                              Trainer, TrainState)

        cfg, tr = cell.config, cell.traffic
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
        self.trainer = Trainer(TrainConfig(**cfg["train"]), device=device)
        st = self.trainer.state
        params, stats = initial_state(st.params, st.batch_stats, seed, device)
        zeros = {n: torch.zeros_like(p) for n, p in params.items()}
        self.trainer.state = TrainState(
            params=params, batch_stats=stats,
            opt_state=OptState(mu=zeros, nu=_clone(zeros), count=0), step=0)
        self.ema = EMA(self.trainer.local_params(), cfg["ema_decay"])
        self.stream = device_batches(self.store, self.batch, seed=seed,
                                     device=device, **self.stream_args)
        self.theta0 = _clone(params)
        self.step_flops = 0.0
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

    # -- the window's call ---------------------------------------------------
    def _next(self):
        return next(self.stream)

    def step(self, record: bool = False) -> int:
        batch = self._next()
        if self.variant == "batch_altered":  # two samples swapped
            batch = {k: v[[1, 0] + list(range(2, v.shape[0]))]
                     for k, v in batch.items()}
        if record:
            self.warm["batches"].append(_clone(batch))
        if self.variant == "state_unchanged":
            metrics = self.trainer.eval_loss(batch)
        else:
            if self.variant == "half_batch":
                batch = {k: v[:self.batch // 2] for k, v in batch.items()}
            metrics = self.trainer.train_step(batch, device_metrics=True)
            self.ema.update(self.trainer.local_params())
        if record:
            self.warm["losses"].append(torch.as_tensor(metrics["loss"])
                                       .detach().clone())
        return self.batch

    # -- the traced run ------------------------------------------------------
    def span_targets(self):
        return [(self, "_next", "bench.train.data", "host")]

    def layer_context(self) -> dict:
        return {"step_flops": self.step_flops}

    # -- the comparison ------------------------------------------------------
    def release(self) -> None:
        """Drop the program's trainer, stream and EMA before the reference
        runs; the warm steps' readings stay."""
        del self.trainer, self.ema, self.stream
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        from ..reference.yolo import data as ref_data
        from ..reference.yolo import trainer as ref_tr

        # the reference runs in float32 whatever the control switched on
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.cell.config
        rt = ref_tr.Trainer(ref_tr.TrainConfig(**cfg["train"]),
                            device=self.device)
        st = rt.state
        params, stats = initial_state(st.params, st.batch_stats, self.seed,
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
                "delta_gap": worst_leaf_gap(d_prog, d_ref, live),
                "ema_gap": worst_leaf_gap(e_prog, e_ref, live)}
