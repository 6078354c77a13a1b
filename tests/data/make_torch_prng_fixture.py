"""Regenerate tests/data/torch_prng_fixture.npz, which chip_smoke.py's train
phase holds the card's seeded draws to.

The file holds, from the JAX package on the CPU:
  - for two untrained networks, per leaf of flax's variable tree (named
    ``params/model_0/conv/kernel`` and so on, kernels in flax's HWIO
    layout): the sha256 of its float32 bytes, the float64 sum and sum of
    squares of its elements, each rounded once (``math.fsum``: the same
    on every machine, whatever order a library sums in), and its first
    256 elements (NaN past a shorter leaf's end):
      ``trainer_n``: ``Trainer(TrainConfig(**TRAIN_SEG), seed=0)``, the
      YOLOv11-n segmenter at train_tissue's 512 defaults (chip_smoke.py's
      train phase);
      ``segmenter_s``: ``TissueSegmenter(512, seed=0)`` without weights,
      the YOLOv11-s that bench.py's ``bench_segmentation`` times;
  - the first ``STREAM["steps"]`` batches of ``device_batches`` over a
    store that ``synthetic_ct_batch`` builds (numpy, in both packages):
    each step's draws (sample indices, flip and mosaic selections, the
    mosaic's indices and scores), following eitx/train/data.py's key
    chain with ``jax.random``, and the sha256 of each array of the batch
    eitx yields;
  - ``meta``: the configurations above as JSON.

chip_smoke.py reads it with numpy only. Run from the repository root, on
the CPU:

    JAX_PLATFORMS=cpu python tests/data/make_torch_prng_fixture.py
"""

import hashlib
import json
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

HEAD = 256
TRAIN_SEG = dict(imgsz=512, nc=4, variant="n", mask_topk=160,
                 max_instances=12, proto_stride=4, assigner="tal",
                 warmup_steps=10, total_steps=100)
SEGMENTER = dict(imgsz=512, variant="s", nc=4, proto_stride=4, seed=0)
STREAM = dict(store=dict(batch=16, imgsz=512, max_instances=12, seed=0),
              batch=8, seed=0, augment=True, flip_h_prob=0.5,
              flip_v_prob=0.25, mosaic_prob=0.5, mosaic_budget=24, steps=3)


def leaf_table(variables) -> dict:
    """Per-leaf names, sha256, float64 sums and sums of squares, first
    elements."""
    names, digests, sums, sq, heads = [], [], [], [], []

    def walk(tree, path):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, path + (k,))
                continue
            a = np.asarray(v, np.float32).ravel()
            names.append("/".join(path + (k,)))
            digests.append(hashlib.sha256(a.tobytes()).hexdigest())
            a64 = a.astype(np.float64)
            sums.append(math.fsum(a64))
            sq.append(math.fsum(a64 * a64))  # float32 squares are exact
            h = np.full(HEAD, np.nan, np.float32)
            h[:min(HEAD, a.size)] = a[:HEAD]
            heads.append(h)

    for col in ("params", "batch_stats"):
        walk(variables[col], (col,))
    return {"names": np.array(names), "sha256": np.array(digests),
            "sum": np.array(sums),
            "sumsq": np.array(sq), "head": np.stack(heads)}


def stream_draws(n: int, i_store: int) -> dict:
    """eitx's device_batches draws for the first steps, from its key chain
    (eitx/train/data.py:207-254, :149, :176)."""
    import jax

    b = STREAM["batch"]
    key = jax.random.PRNGKey(STREAM["seed"])
    out = {k: [] for k in ("idx", "flip_h", "flip_v", "mosaic", "idx4",
                           "score")}
    for _ in range(STREAM["steps"]):
        key, sub = jax.random.split(key)
        kidx, kh, kv, km, kmi, ksel = jax.random.split(sub, 6)
        out["idx"].append(jax.random.randint(kidx, (b,), 0, n))
        out["flip_h"].append(jax.random.uniform(kh, (b,))
                             < STREAM["flip_h_prob"])
        out["flip_v"].append(jax.random.uniform(kv, (b,))
                             < STREAM["flip_v_prob"])
        out["mosaic"].append(jax.random.uniform(km, (b,))
                             < STREAM["mosaic_prob"])
        out["idx4"].append(jax.random.randint(kmi, (b, 4), 0, n))
        out["score"].append(jax.random.uniform(ksel, (b, 4 * i_store)))
    return {k: np.stack([np.asarray(x) for x in v]) for k, v in out.items()}


def batch_digests(batch) -> list:
    return [hashlib.sha256(np.ascontiguousarray(np.asarray(batch[k]))
                           .tobytes()).hexdigest() for k in sorted(batch)]


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from eitx.models.yolo.infer import TissueSegmenter
    from eitx.train import TrainConfig, Trainer
    from eitx.train.data import device_batches, synthetic_ct_batch
    from torch_prng_check import u8_store

    tables = {}
    tr = Trainer(TrainConfig(**TRAIN_SEG), seed=0)
    tables["trainer_n"] = leaf_table(
        {"params": tr.state.params, "batch_stats": tr.state.batch_stats})
    seg = TissueSegmenter(**SEGMENTER)
    tables["segmenter_s"] = leaf_table(seg.variables)

    store = u8_store(synthetic_ct_batch(**STREAM["store"]))
    kw = {k: STREAM[k] for k in ("seed", "augment", "flip_h_prob",
                                 "flip_v_prob", "mosaic_prob",
                                 "mosaic_budget")}
    it = device_batches(store, STREAM["batch"], **kw)
    digests = [batch_digests(next(it)) for _ in range(STREAM["steps"])]
    draws = stream_draws(store["images"].shape[0], store["boxes"].shape[1])

    arrays = {f"{net}_{k}": v for net, t in tables.items()
              for k, v in t.items()}
    arrays.update({f"stream_{k}": v for k, v in draws.items()})
    arrays["stream_keys"] = np.array(sorted(store))
    arrays["stream_sha256"] = np.array(digests)
    arrays["meta"] = np.array(json.dumps({
        "trainer_n": dict(TRAIN_SEG, seed=0), "segmenter_s": SEGMENTER,
        "stream": STREAM, "head": HEAD}))
    out = os.path.join(ROOT, "tests", "data", "torch_prng_fixture.npz")
    np.savez_compressed(out, **arrays)
    print(out, os.path.getsize(out), "bytes;",
          {net: len(t["names"]) for net, t in tables.items()}, "leaves")


if __name__ == "__main__":
    main()
