"""Serving-checkpoint discovery.

The reference pins three fixed weight paths in `kt_service_config.py:1-3`
(yolov11s rib detector + two yolov11 seg checkpoints at imgsz 256/512).
eitx trains its checkpoints in-repo and may carry more than one capacity
variant per slot; this resolver picks the preferred trained checkpoint
for each serving slot: the largest-capacity variant present wins
("s" over "n"), mirroring the reference's s-class production weights
while keeping the lighter n-variant as a fallback.
"""

from __future__ import annotations

import os

# capacity preference, best first (matches yolov11_spec variants)
_VARIANT_PREF = ("s", "n")


def repo_weights_dir() -> str:
    """`weights/` at the repo root (two levels above this package)."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "weights",
    )


def find_checkpoint(stem: str, size: int,
                    weights_dir: str | None = None) -> str | None:
    """Best existing `<stem>_<variant>_<size>.msgpack` under weights_dir.

    `stem` is the serving slot ("tissue" or "ribs"), `size` the imgsz the
    slot serves (the reference keys its two seg checkpoints by input
    height, utils.py:1282-1307). Returns None when the slot is untrained.
    """
    wdir = weights_dir or repo_weights_dir()
    for variant in _VARIANT_PREF:
        p = os.path.join(wdir, f"{stem}_{variant}_{size}.msgpack")
        if os.path.exists(p):
            return p
    return None
