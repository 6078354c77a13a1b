"""The port's seeded draws against tests/data/torch_prng_fixture.npz, which
tests/data/make_torch_prng_fixture.py makes from the JAX package: the
initial parameters of two untrained networks and the first batches of
``device_batches``. numpy and torch only: chip_smoke.py's train phase runs
it on the card, tests/test_torch_prng.py on the CPU. Not collected by
pytest."""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Dict, List

import numpy as np
import torch

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_prng_fixture.npz")


def load_fixture() -> dict:
    with np.load(FIXTURE) as f:
        fx = {k: f[k] for k in f.files}
    fx["meta"] = json.loads(str(fx["meta"]))
    return fx


def u8_store(store: dict) -> dict:
    """synthetic_ct_batch's float store as a training store: uint8 images
    and masks (the fixture's maker and the checks both convert so)."""
    out = dict(store)
    for k in ("images", "masks"):
        out[k] = np.round(store[k] * 255).astype(np.uint8)
    return out


def leaf_errors(fx: dict, net: str, state: Dict[str, torch.Tensor]) -> dict:
    """A network's parameters and statistics (a state dict, any device)
    against the fixture's leaves of ``net``: the names, the leaves whose
    bytes differ (sha256), every leaf's float64 sum and sum of squares
    (exactly rounded, equal or not), and the largest distance in float32
    ulps over the leaves' first elements."""
    from eitx_torch.models.yolo.checkpoint import torch_to_flax_tree

    head = fx["meta"]["head"]
    params, stats = torch_to_flax_tree(
        {n: t.detach().cpu() for n, t in state.items()})
    got = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                got["/".join(path + (k,))] = np.asarray(v, np.float32).ravel()

    walk(params, ("params",))
    walk(stats, ("batch_stats",))
    names = [str(n) for n in fx[f"{net}_names"]]
    if sorted(got) != sorted(names):
        return {"leaves": len(got), "names_equal": False}
    sums_equal, max_ulp, differ = True, 0, []
    for i, name in enumerate(names):
        a = got[name]
        if hashlib.sha256(a.tobytes()).hexdigest() != str(
                fx[f"{net}_sha256"][i]):
            differ.append(name)
        a64 = a.astype(np.float64)
        sums_equal &= bool(math.fsum(a64) == fx[f"{net}_sum"][i])
        sums_equal &= bool(math.fsum(a64 * a64) == fx[f"{net}_sumsq"][i])
        n = min(head, a.size)
        want = fx[f"{net}_head"][i, :n].view(np.int32).astype(np.int64)
        max_ulp = max(max_ulp, int(np.abs(
            a[:n].view(np.int32).astype(np.int64) - want).max(initial=0)))
    return {"leaves": len(names), "names_equal": True,
            "leaves_differ": differ, "sums_equal": sums_equal,
            "max_ulp": max_ulp}


# device_batches' arguments that the fixture's meta records
_STREAM_ARGS = ("seed", "augment", "flip_h_prob", "flip_v_prob",
                "mosaic_prob", "mosaic_budget")


def stream(fx: dict, device):
    """The port's ``device_batches`` over the fixture's store, with the
    fixture's arguments, on ``device``: the generator (a store of
    ``synthetic_ct_batch``, built on the host)."""
    from eitx_torch.train.data import device_batches, synthetic_ct_batch

    s = fx["meta"]["stream"]
    store = u8_store(synthetic_ct_batch(**s["store"]))
    return device_batches(store, s["batch"], device=device,
                          **{k: s[k] for k in _STREAM_ARGS})


def stream_errors(fx: dict, batches: List[dict]) -> dict:
    """The first batches (dicts of tensors, any device) and the port's
    host draws for them against the fixture: which draws differ, and the
    steps whose arrays' sha256 differ from eitx's batches'."""
    from eitx_torch.core import prng
    from eitx_torch.train.data import _named_draws, _stream_draws

    s = fx["meta"]["stream"]
    st = s["store"]
    steps = s["steps"]
    _, block = _stream_draws(prng.key(s["seed"]), steps, s["batch"],
                             st["batch"], st["max_instances"], s["augment"],
                             s["flip_h_prob"], s["flip_v_prob"],
                             s["mosaic_prob"])
    got = _named_draws(block, s["batch"])
    draws_differ = sorted(
        k for k, v in got.items()
        if not np.array_equal(np.asarray(v).view(np.uint8),
                              np.asarray(fx[f"stream_{k}"]).view(np.uint8)))
    keys = [str(k) for k in fx["stream_keys"]]
    sha_differ = []
    for i, batch in enumerate(batches[:steps]):
        digests = [hashlib.sha256(np.ascontiguousarray(
            batch[k].cpu().numpy()).tobytes()).hexdigest() for k in keys]
        if digests != [str(d) for d in fx["stream_sha256"][i]]:
            sha_differ.append(i)
    return {"steps": steps, "draws_differ": draws_differ,
            "batches_differ": sha_differ}
