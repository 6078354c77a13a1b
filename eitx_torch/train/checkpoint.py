"""Training checkpoint save/restore, in the JAX package's msgpack format.

Port of eitx/train/checkpoint.py. A ``.train`` file holds
``{"params", "batch_stats", "opt_state", "step"}`` as flax writes it
(``serialization.to_bytes``): flax variable trees with HWIO kernels and
optax's adamw state (``models/yolo/checkpoint.py`` maps both ways), so a
file written by either package loads in the other.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..core.errors import ModelError
from ..models.yolo.checkpoint import (
    flax_to_torch_opt_state,
    flax_to_torch_state,
    torch_to_flax_opt_state,
    torch_to_flax_tree,
    unpackb,
    write_msgpack_checkpoint,
)
from .trainer import OptState, TrainState


def save_checkpoint(path: str, state: TrainState) -> str:
    params, _ = torch_to_flax_tree(state.params)
    _, batch_stats = torch_to_flax_tree(state.batch_stats)
    payload = {
        "params": params,
        "batch_stats": batch_stats,
        "opt_state": torch_to_flax_opt_state(
            state.opt_state.mu, state.opt_state.nu, state.opt_state.count),
        "step": int(state.step),
    }
    return write_msgpack_checkpoint(path, payload, sort_keys=False)


def _read_tree(path: str) -> Dict:
    with open(path, "rb") as fh:
        return unpackb(fh.read())


def peek_step(path: str) -> int:
    """The step recorded in a ``.train`` checkpoint.

    Callers that resume MUST read this BEFORE building the Trainer: the
    LR schedule is indexed by the optimizer count restored from the
    checkpoint, so a resumed run has to extend ``total_steps`` past that
    count or the cosine tail evaluates to ~0 and every continued step is
    a no-op.
    """
    return int(_read_tree(path)["step"])


def load_checkpoint(path: str, like: TrainState,
                    tree: Optional[Dict] = None) -> TrainState:
    """Restore into the structure of an existing TrainState (names, shapes
    and device from a freshly built Trainer). Pass ``tree`` (an already
    decoded payload) to avoid re-reading the file — resume flows decode
    the checkpoint once for the step peek and reuse it here."""
    if tree is None:
        tree = _read_tree(path)
    state = flax_to_torch_state(tree["params"], tree.get("batch_stats") or {})
    mu, nu, count = flax_to_torch_opt_state(tree["opt_state"])

    def fit(src: Dict, ref: Dict, what: str) -> Dict:
        if set(src) != set(ref):
            raise ModelError(
                f"{path}: {what} do not fit the model: missing "
                f"{sorted(set(ref) - set(src))[:4]}, unexpected "
                f"{sorted(set(src) - set(ref))[:4]}")
        out = {}
        for n, r in ref.items():
            if tuple(src[n].shape) != tuple(r.shape):
                raise ModelError(f"{path}: {what} {n} has shape "
                                 f"{tuple(src[n].shape)}, model "
                                 f"{tuple(r.shape)}")
            out[n] = src[n].to(r.device, r.dtype)
        return out

    return TrainState(
        params=fit({n: state[n] for n in state if n in like.params
                    or not n.endswith(("running_mean", "running_var"))},
                   like.params, "params"),
        batch_stats=fit({n: t for n, t in state.items()
                         if n.endswith(("running_mean", "running_var"))},
                        like.batch_stats, "batch statistics"),
        opt_state=OptState(mu=fit(mu, like.params, "first moments"),
                           nu=fit(nu, like.params, "second moments"),
                           count=count),
        step=int(tree["step"]),
    )
