"""Ultralytics ``.pt`` checkpoints and eitx msgpack checkpoints -> this
package's state dicts.

Port of eitx/models/yolo/convert.py (``load_torch_state`` :48,
``convert_state_to_variables`` :102, ``convert_ultralytics_checkpoint``
:175, ``restore_checkpoint_tree`` / ``load_eitx_checkpoint`` /
``peek_checkpoint_meta`` :202-237, ``merge_state_dict`` :240,
``load_weights`` :287). The archive is read by ``ptread`` (the zip/pickle
format parsed directly into numpy, no torch unpickling and no
ultralytics), then the nn.Module stub graph is walked via
``_parameters``/``_buffers``/``_modules`` to recover the state dict. This
package's modules keep ultralytics' names (``model.N.*``) and NCHW
layouts, so a ``.pt`` state maps onto them name for name, without the
reference's OIHW -> HWIO transposes.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from ...core.errors import ModelError
from .checkpoint import flax_to_torch_state, unpackb


def _as_f32(t) -> np.ndarray:
    a = np.asarray(t)
    if a.dtype != np.float32 and np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    return a


def _collect_tensors(obj, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """Walk an nn.Module stub graph via _parameters/_buffers/_modules."""
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    for slot in ("_parameters", "_buffers"):
        entries = d.get(slot)
        if entries:
            for name, t in dict(entries).items():
                if isinstance(t, np.ndarray):
                    out[prefix + name] = _as_f32(t)
    modules = d.get("_modules")
    if modules:
        for name, child in dict(modules).items():
            if child is not None:
                _collect_tensors(child, prefix + name + ".", out)


def load_torch_state(pt_path: str) -> Dict[str, np.ndarray]:
    """Read an ultralytics (or raw) .pt file into {name: float32 array}.

    The zip/pickle archive is parsed by ptread.load_pt_archive, which
    unpickles no torch class. Prefers the 'ema' weights when present
    (ultralytics' attempt_load does the same).
    """
    from .ptread import load_pt_archive

    try:
        ckpt = load_pt_archive(pt_path)
    except Exception as e:
        raise ModelError(f"cannot unpickle checkpoint {pt_path}: {e}") from e
    state: Dict[str, np.ndarray] = {}
    if isinstance(ckpt, dict) and not all(
        isinstance(v, np.ndarray) for v in ckpt.values()
    ):
        for source in ("ema", "model"):
            mod = ckpt.get(source)
            if mod is not None and not isinstance(mod, np.ndarray):
                _collect_tensors(mod, "", state)
                if state:
                    break
    elif isinstance(ckpt, dict):  # raw state dict
        for k, v in ckpt.items():
            if isinstance(v, np.ndarray):
                state[k] = _as_f32(v)
    if not state:
        raise ModelError(f"no tensors found in checkpoint {pt_path}")
    return state


def convert_state_to_variables(
    state: Dict[str, np.ndarray], template: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Fill a state-dict template (``model.state_dict()``) with the
    checkpoint's tensors, name for name, in the template's dtypes and
    devices.

    Raises ModelError for a checkpoint tensor with no destination or a
    shape that differs (DFL's fixed kernel and num_batches_tracked
    counters are skipped by design, as in the reference)."""
    out = dict(template)
    unmatched = []
    for key, value in state.items():
        if key.endswith("num_batches_tracked") or ".dfl." in key:
            continue
        if key not in template:
            unmatched.append(key)
            continue
        dst = template[key]
        if tuple(dst.shape) != tuple(value.shape):
            raise ModelError(
                f"shape mismatch for {key}: checkpoint {value.shape} vs "
                f"model {tuple(dst.shape)}")
        out[key] = torch.as_tensor(np.ascontiguousarray(value)).to(
            dst.device, dst.dtype)
    if unmatched:
        raise ModelError(
            f"{len(unmatched)} checkpoint tensors had no destination, e.g. "
            + ", ".join(unmatched[:8])
        )
    return out


def convert_ultralytics_checkpoint(pt_path: str,
                                   model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Load a .pt checkpoint into a state dict for ``model`` (a
    YoloV11)."""
    return convert_state_to_variables(load_torch_state(pt_path),
                                      model.state_dict())


def restore_checkpoint_tree(path: str) -> Dict:
    """Read + msgpack-decode an eitx checkpoint once; callers share the
    restored tree between peek_checkpoint_meta and load_weights so runner
    construction doesn't pay checkpoint I/O twice."""
    with open(path, "rb") as fh:
        return unpackb(fh.read())


def load_eitx_checkpoint(path: str, tree: Dict = None) -> Dict[str, torch.Tensor]:
    """An eitx-native msgpack checkpoint -> a state dict (parameters and
    BatchNorm statistics). Accepts either a deployment dict
    {params[, batch_stats]} (what scripts/train_tissue.py saves from the
    EMA weights) or a full training payload (train/checkpoint.py) —
    opt_state/step are dropped."""
    if tree is None:
        tree = restore_checkpoint_tree(path)
    if "params" not in tree:
        raise ModelError(f"checkpoint {path} has no 'params' tree")
    return flax_to_torch_state(tree["params"], tree.get("batch_stats") or {})


def peek_checkpoint_meta(path: str, tree: Dict = None) -> Dict:
    """Read the 'meta' dict of an eitx msgpack checkpoint without building
    a model ({} for .pt archives or checkpoints without meta)."""
    if path.endswith(".pt"):
        return {}
    if tree is None:
        tree = restore_checkpoint_tree(path)
    meta = tree.get("meta")
    return dict(meta) if isinstance(meta, dict) else {}


def _leaf_like(value, like):
    """``value`` in the type, dtype and device of the template leaf."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(value.detach().cpu()
                                          if isinstance(value, torch.Tensor)
                                          else value)).to(like.device,
                                                          like.dtype)
    return np.asarray(value).astype(np.asarray(like).dtype)


def merge_state_dict(template, state):
    """Tolerant warm start: copy every leaf of ``state`` whose path AND
    shape match into ``template`` (a fresh-init tree or state dict); every
    other template leaf keeps its fresh initialization.

    A strict load breaks warm starting across architecture extensions
    (e.g. a ``proto_stride=2`` graph adds proto.upsample2/proto.cv2b and
    reshapes proto.cv3 — everything else is transferable). Returns
    ``(merged, copied_paths, skipped_paths, unused_paths)``: ``skipped``
    are template leaves left at fresh init, ``unused`` are CHECKPOINT
    leaves with no matching/same-shape home in the template — a non-empty
    ``unused`` usually means trained weights are being dropped, so
    callers should log it loudly.
    """
    copied, skipped, unused = [], [], []

    def rec(t, s, path):
        if isinstance(t, Mapping):
            out = {}
            for k, v in t.items():
                if isinstance(s, Mapping) and k in s:
                    out[k] = rec(v, s[k], path + (k,))
                else:
                    skipped.append("/".join(path + (k,)))
                    out[k] = v
            if isinstance(s, Mapping):
                for k in s:
                    if k not in t:
                        unused.append("/".join(path + (k,)))
            return out
        if tuple(np.shape(s)) == tuple(np.shape(t)):
            copied.append("/".join(path))
            return _leaf_like(s, t)
        skipped.append("/".join(path))
        unused.append("/".join(path))
        return t

    merged = rec(dict(template), state, ())
    return merged, copied, skipped, unused


def load_weights(pt_path: str, model: torch.nn.Module,
                 tree: Dict = None) -> Dict[str, torch.Tensor]:
    """Convenience: checkpoint path -> a state dict ready for
    ``model.load_state_dict``. ``.pt`` files go through the archive
    converter; anything else is an eitx-native msgpack checkpoint (pass
    ``tree`` to reuse an already-restored payload)."""
    if pt_path.endswith(".pt"):
        return convert_ultralytics_checkpoint(pt_path, model)
    return load_eitx_checkpoint(pt_path, tree=tree)
