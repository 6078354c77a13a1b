"""The JAX package's msgpack checkpoints, read without JAX, flax or msgpack.

``read_msgpack_checkpoint`` decodes the file with a minimal msgpack
decoder (maps, arrays, str, bin, int, float, bool, nil and ext code 1 —
flax's ndarray record: a msgpack (shape, dtype name, raw bytes) triple).
``flax_to_torch_state`` maps the flax variable tree onto this package's
``nn.Module`` names: it inverts ``eitx.models.yolo.convert._flax_path``
(``model_23/cv3_0_1_0/conv/kernel`` -> ``model.23.cv3.0.1.0.conv.weight``)
and turns HWIO kernels back into OIHW. A flax ``ConvTranspose`` with
``transpose_kernel=True`` stores (kh, kw, O, I) for torch's (I, O, kh, kw),
so both kernel kinds take the same transpose.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np
import torch

from ...core.errors import ModelError

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ModelError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode(r: _Reader):
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(r, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    sized = {
        0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
        0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
        0xDC: (">H", "array"), 0xDD: (">I", "array"),
        0xDE: (">H", "map"), 0xDF: (">I", "map"),
        0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    }
    if b in sized:
        fmt, kind = sized[b]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return bytes(r.take(n)).decode("utf-8")
        if kind == "array":
            return _array(r, n)
        if kind == "map":
            return _map(r, n)
        return _ext(r.unpack(">b"), r.take(n))
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        return _ext(r.unpack(">b"), r.take(fixext[b]))
    scalars = {
        0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
        0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
    }
    if b in scalars:
        return r.unpack(scalars[b])
    raise ModelError(f"unsupported msgpack type byte 0x{b:02x}")


def _array(r: _Reader, n: int) -> list:
    return [_decode(r) for _ in range(n)]


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def _ext(code: int, data: memoryview):
    if code != _EXT_NDARRAY:
        raise ModelError(f"unsupported msgpack ext code {code}")
    shape, dtype, raw = unpackb(bytes(data))
    if isinstance(dtype, bytes):
        dtype = dtype.decode("ascii")
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def unpackb(data: bytes):
    """Decode one msgpack object from ``data``."""
    r = _Reader(data)
    obj = _decode(r)
    if r.pos != len(data):
        raise ModelError(f"{len(data) - r.pos} trailing bytes after msgpack data")
    return obj


def read_msgpack_checkpoint(path: str) -> Tuple[Dict, Dict, Dict]:
    """An eitx msgpack checkpoint -> (meta, params, batch_stats)."""
    with open(path, "rb") as fh:
        tree = unpackb(fh.read())
    if not isinstance(tree, dict) or "params" not in tree:
        raise ModelError(f"checkpoint {path} has no 'params' tree")
    meta = tree.get("meta")
    return (dict(meta) if isinstance(meta, dict) else {},
            tree["params"], tree.get("batch_stats") or {})


def _torch_module_path(flax_path: Tuple[str, ...]) -> list:
    """Inverse of convert._flax_path on the module part of a path."""
    out = []
    for tok in flax_path:
        head, *rest = tok.split("_")
        if head == "proto" and rest:
            out += ["proto", "_".join(rest)]
        elif rest and all(t.isdigit() for t in rest):
            out += [head, *rest]
        else:
            out.append(tok)
    return out


_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def flax_to_torch_state(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """Flax variable trees (nested dicts of numpy arrays) -> state dict."""
    state: Dict[str, torch.Tensor] = {}

    def walk(tree, path, collection):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,), collection)
                continue
            leaf = _LEAVES.get((collection, k))
            if leaf is None:
                raise ModelError(f"unknown {collection} leaf {'/'.join(path + (k,))}")
            a = np.asarray(v, dtype=np.float32)
            if k == "kernel" and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)  # (kh, kw, I, O) -> (O, I, kh, kw)
            name = ".".join(_torch_module_path(path) + [leaf])
            state[name] = torch.tensor(np.ascontiguousarray(a))

    walk(params, (), "params")
    walk(batch_stats, (), "batch_stats")
    return state


def load_state(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load ``state`` into ``model``; every parameter and statistic must be
    covered (BatchNorm's ``num_batches_tracked`` counters excepted)."""
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ModelError(
            f"checkpoint does not fit the model: missing {missing[:8]}, "
            f"unexpected {unexpected[:8]}"
        )
