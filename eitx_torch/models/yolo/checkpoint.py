"""The JAX package's msgpack checkpoints, read and written without JAX,
flax or msgpack.

``read_msgpack_checkpoint`` decodes the file with a minimal msgpack
decoder (maps, arrays, str, bin, int, float, bool, nil and ext code 1 —
flax's ndarray record: a msgpack (shape, dtype name, raw bytes) triple);
``packb`` is the matching encoder, which writes what
``flax.serialization.msgpack_serialize`` writes for the same tree, so a
file written here loads through flax. ``flax_to_torch_state`` maps the
flax variable tree onto this package's ``nn.Module`` names: it inverts
``eitx.models.yolo.convert._flax_path`` (``model_23/cv3_0_1_0/conv/kernel``
-> ``model.23.cv3.0.1.0.conv.weight``) and turns HWIO kernels back into
OIHW; ``torch_to_flax_tree`` goes the other way. A flax ``ConvTranspose``
with ``transpose_kernel=True`` stores (kh, kw, O, I) for torch's
(I, O, kh, kw), so both kernel kinds take the same transpose. The
optimizer state of a training checkpoint (optax's
``chain(clip_by_global_norm, adamw(schedule))``) maps the same way:
``flax_to_torch_opt_state`` / ``torch_to_flax_opt_state``.
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


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return struct.pack(">B", n)
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return struct.pack(">B", code) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                return struct.pack(">B", code) + struct.pack(fmt, n)
    raise ModelError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes) -> bytes:
    if n <= fix_max and fix is not None:
        return struct.pack(">B", fix | n)
    for code, fmt, top in codes:
        if n <= top:
            return struct.pack(">B", code) + struct.pack(fmt, n)
    raise ModelError(f"length {n} does not fit msgpack")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool):
        out.append(_pack_int(int(obj)))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_pack_len(len(raw), 0xA0, 31, ((0xD9, ">B", 0xFF),
                                                   (0xDA, ">H", 0xFFFF),
                                                   (0xDB, ">I", 0xFFFFFFFF))))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_pack_len(len(obj), None, -1, ((0xC4, ">B", 0xFF),
                                                   (0xC5, ">H", 0xFFFF),
                                                   (0xC6, ">I", 0xFFFFFFFF))))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), 0x90, 15, ((0xDC, ">H", 0xFFFF),
                                                   (0xDD, ">I", 0xFFFFFFFF))))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_map(obj, sorted(obj), out)  # flax's tree map orders the keys
    elif isinstance(obj, (np.ndarray, np.generic)):
        # flax's ndarray record: ext 1 around msgpack (shape, dtype, bytes)
        arr = np.asarray(obj)
        if arr.dtype.hasobject:
            raise ModelError(f"cannot serialise an array of {arr.dtype}")
        data = packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        n = len(data)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(struct.pack(">Bb", fixext[n], _EXT_NDARRAY))
        else:
            out.append(_pack_len(n, None, -1, ((0xC7, ">B", 0xFF),
                                               (0xC8, ">H", 0xFFFF),
                                               (0xC9, ">I", 0xFFFFFFFF))))
            out.append(struct.pack(">b", _EXT_NDARRAY))
        out.append(data)
    elif isinstance(obj, torch.Tensor):
        _pack(obj.detach().cpu().numpy(), out)
    else:
        raise ModelError(f"cannot serialise {type(obj).__name__}")


def _pack_map(obj: dict, keys, out: list) -> None:
    out.append(_pack_len(len(obj), 0x80, 15, ((0xDE, ">H", 0xFFFF),
                                               (0xDF, ">I", 0xFFFFFFFF))))
    for k in keys:
        _pack(k, out)
        _pack(obj[k], out)


def packb(obj, sort_keys: bool = True) -> bytes:
    """Encode ``obj`` (dicts with str keys, lists, tuples, str, bytes,
    int, float, bool, None, numpy arrays and tensors) as msgpack, arrays
    as flax's ndarray records and map keys sorted: the bytes
    ``flax.serialization.msgpack_serialize`` writes for the same tree.
    ``sort_keys=False`` keeps the top-level map in insertion order, as
    ``flax.serialization.to_bytes`` writes eitx's training payload (whose
    subtrees, made by jax tree maps, have sorted keys)."""
    out: list = []
    if isinstance(obj, dict) and not sort_keys:
        _pack_map(obj, list(obj), out)
    else:
        _pack(obj, out)
    return b"".join(out)


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
    ("params", "gamma"): "gamma",
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


def flax_path(torch_key: str) -> Tuple[Tuple[str, ...], str]:
    """torch state name -> (flax module path, torch leaf name): numeric
    components merge into the preceding name (``m.0`` -> ``m_0``), and
    every module of the proto merges too (``proto.cv1`` -> ``proto_cv1``,
    ``proto.upsample2`` -> ``proto_upsample2``: eitx's head names them
    flat, eitx/models/yolo/model.py:108-125). The JAX package's
    ``convert._flax_path`` merges only the ultralytics proto's
    ``cv1``-``cv3`` and ``upsample``; ``_torch_module_path`` is the
    inverse of both."""
    tokens = torch_key.split(".")
    leaf = tokens[-1]
    path: list = []
    for t in tokens[:-1]:
        if t.isdigit() and path:
            path[-1] = f"{path[-1]}_{t}"
        elif path and path[-1] == "proto":
            path[-1] = f"proto_{t}"
        else:
            path.append(t)
    return tuple(path), leaf


def _flax_leaf(leaf: str, ndim: int) -> Tuple[str, str]:
    """torch leaf -> (flax collection, flax leaf)."""
    if leaf == "weight":
        return "params", "kernel" if ndim == 4 else "scale"
    if leaf in ("bias", "gamma"):  # gamma: YOLO12's layer scale
        return "params", leaf
    if leaf == "running_mean":
        return "batch_stats", "mean"
    if leaf == "running_var":
        return "batch_stats", "var"
    raise ModelError(f"no flax counterpart for torch leaf {leaf!r}")


def torch_to_flax_tree(state: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """A state dict (or a dict of parameter-shaped tensors) -> flax
    (params, batch_stats) trees of numpy arrays, OIHW kernels as HWIO.
    BatchNorm's ``num_batches_tracked`` counters have no flax counterpart
    and are left out."""
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for name, t in state.items():
        if name.endswith("num_batches_tracked"):
            continue
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)
        path, leaf = flax_path(name)
        collection, fleaf = _flax_leaf(leaf, a.ndim)
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)  # (O, I, kh, kw) -> (kh, kw, I, O)
        node = trees[collection]
        for p in path:
            node = node.setdefault(p, {})
        node[fleaf] = np.ascontiguousarray(a, dtype=np.float32)
    return trees["params"], trees["batch_stats"]


def flax_to_torch_opt_state(opt_state: Dict) -> Tuple[Dict[str, torch.Tensor],
                                                      Dict[str, torch.Tensor],
                                                      int]:
    """The serialized optax state of ``chain(clip_by_global_norm,
    adamw(schedule))`` — ``(EmptyState, (ScaleByAdamState(count, mu, nu),
    EmptyState, ScaleByScheduleState(count)))``, which flax writes as
    ``{"0": {}, "1": {"0": {count, mu, nu}, "1": {}, "2": {count}}}`` —
    -> (first moments, second moments, step count), the moments as state
    dicts keyed by parameter name."""
    try:
        adam = opt_state["1"]["0"]
        count = int(np.asarray(adam["count"]))
        sched = int(np.asarray(opt_state["1"]["2"]["count"]))
        mu = flax_to_torch_state(adam["mu"], {})
        nu = flax_to_torch_state(adam["nu"], {})
    except (KeyError, TypeError) as e:
        raise ModelError(f"not an adamw optimizer state: {e}") from e
    if sched != count:
        raise ModelError(f"adam count {count} != schedule count {sched}")
    return mu, nu, count


def torch_to_flax_opt_state(mu: Dict[str, torch.Tensor],
                            nu: Dict[str, torch.Tensor], count: int) -> Dict:
    """Inverse of ``flax_to_torch_opt_state``: the serialized optax tree."""
    c = np.asarray(count, np.int32)
    return {"0": {}, "1": {
        "0": {"count": c, "mu": torch_to_flax_tree(mu)[0],
              "nu": torch_to_flax_tree(nu)[0]},
        "1": {},
        "2": {"count": c.copy()},
    }}


def write_msgpack_checkpoint(path: str, payload: Dict,
                             sort_keys: bool = True) -> str:
    """``payload`` (flax trees, meta, ...) as a msgpack file (``packb``);
    written to a temporary name and renamed into place."""
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(packb(payload, sort_keys=sort_keys))
    os.replace(tmp, path)
    return path


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
