"""Pure-Python reader for the torch zip checkpoint format (no torch).

A copy of eitx/models/yolo/ptread.py (the port keeps its own). The
reference loads its three YOLOv11 checkpoints through the torch /
ultralytics runtime (ai_tools.py:69-71); the deployment image here installs
no torch, so the archive is parsed directly: a ``.pt`` file (torch >= 1.6)
is a zip containing ``<name>/data.pkl`` (the pickled object graph) plus one
raw little-endian blob per tensor storage under ``<name>/data/<key>``.
Tensors inside the pickle are persistent-id references
``('storage', StorageType, key, location, numel)`` rebuilt through
``torch._utils._rebuild_tensor_v2`` — both hooks are intercepted and
produce numpy arrays; every other torch class is replaced by an inert stub
so arbitrary nn.Module graphs (what ultralytics pickles) deserialize
without the library. Of the Python and numpy modules whose names are
resolved for real, only the data types and rebuild helpers an archive
needs are allowed: a name such as ``builtins.exec`` is refused (eitx's
reader allows every name of those modules).
"""

from __future__ import annotations

import io
import pickle
import zipfile
from typing import Callable, Dict

import numpy as np

# torch storage class name -> numpy dtype (bfloat16 handled separately)
_STORAGE_DTYPES = {
    "FloatStorage": np.dtype("<f4"),
    "DoubleStorage": np.dtype("<f8"),
    "HalfStorage": np.dtype("<f2"),
    "LongStorage": np.dtype("<i8"),
    "IntStorage": np.dtype("<i4"),
    "ShortStorage": np.dtype("<i2"),
    "CharStorage": np.dtype("<i1"),
    "ByteStorage": np.dtype("<u1"),
    "BoolStorage": np.dtype("?"),
    "BFloat16Storage": np.dtype("<u2"),  # raw bits; widened on load
}


class _StorageType:
    """Marker for ``torch.XStorage`` globals inside the pickle stream."""

    def __init__(self, name: str):
        self.name = name
        self.dtype = _STORAGE_DTYPES.get(name, np.dtype("<u1"))
        self.is_bf16 = name == "BFloat16Storage"


class _Stub:
    """Inert stand-in for any torch class; keeps __dict__/state only."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __call__(self, *a, **k):  # some reduces invoke factory callables
        return self


def _rebuild_tensor(storage: np.ndarray, offset, size, stride, *rest):
    """torch._utils._rebuild_tensor(_v2) -> owned numpy array."""
    size = tuple(int(s) for s in size)
    stride = tuple(int(s) for s in stride)
    base = storage[int(offset):]
    if not size:
        return base[:1].copy().reshape(())
    itemsize = storage.dtype.itemsize
    view = np.lib.stride_tricks.as_strided(
        base,
        shape=size,
        strides=tuple(s * itemsize for s in stride),
        writeable=False,
    )
    return view.copy()


def _rebuild_parameter(data, *rest):
    return data


def _rebuild_from_type_v2(func, new_type, args, state):
    # tensor subclasses (rare in ultralytics ckpts) collapse to plain data
    return func(*args)


# the library globals a torch archive refers to; any other name of these
# modules (builtins.exec, builtins.getattr, numpy.load, ...) is refused,
# since unpickling would call it
_DATA_TYPES = {"bool", "bytearray", "bytes", "complex", "dict", "float",
               "frozenset", "int", "list", "object", "range", "set", "slice",
               "str", "tuple"}
_NUMPY_NAMES = {"_reconstruct", "scalar", "ndarray", "dtype", "_frombuffer"}
_SAFE_GLOBALS = {
    "builtins": _DATA_TYPES,
    "copyreg": {"_reconstructor"},
    "_codecs": {"encode"},
    "collections": {"OrderedDict", "defaultdict", "deque", "Counter"},
    "numpy": _NUMPY_NAMES,
    "numpy.core.multiarray": _NUMPY_NAMES,
    "numpy._core.multiarray": _NUMPY_NAMES,
    "numpy.core.numeric": _NUMPY_NAMES,
    "numpy._core.numeric": _NUMPY_NAMES,
}


class _TorchUnpickler(pickle.Unpickler):
    """persistent_load materializes each storage blob as a numpy array."""

    def __init__(self, file, read_blob: Callable[[str], bytes]):
        super().__init__(file, encoding="latin1")
        self._read_blob = read_blob
        self._cache: Dict[str, np.ndarray] = {}

    def persistent_load(self, pid):
        if isinstance(pid, tuple) and pid and pid[0] == "storage":
            _, stype, key, _location, _numel = pid
            key = str(key)
            if key not in self._cache:
                if not isinstance(stype, _StorageType):
                    stype = _StorageType(getattr(stype, "__name__", str(stype)))
                arr = np.frombuffer(self._read_blob(key), dtype=stype.dtype)
                if stype.is_bf16:
                    arr = (arr.astype(np.uint32) << 16).view(np.float32)
                self._cache[key] = arr
            return self._cache[key]
        raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")

    def find_class(self, module, name):
        if module in _SAFE_GLOBALS:
            if name in _SAFE_GLOBALS[module]:
                return super().find_class(module, name)
            raise pickle.UnpicklingError(
                f"checkpoint refers to {module}.{name}, which a torch "
                "archive does not need")
        if module == "torch._utils":
            if name in ("_rebuild_tensor_v2", "_rebuild_tensor"):
                return _rebuild_tensor
            if name == "_rebuild_parameter":
                return _rebuild_parameter
        if module == "torch" and name.endswith("Storage"):
            return _StorageType(name)
        if module == "torch" and name == "Size":
            return tuple
        if name == "_rebuild_from_type_v2":
            return _rebuild_from_type_v2
        return type(name, (_Stub,), {"__module__": module})


def load_pt_archive(pt_path: str):
    """Deserialize a torch zip checkpoint; tensors come back as numpy.

    Returns the top-level pickled object (for ultralytics: a dict with
    'model'/'ema' stub-module graphs whose _parameters/_buffers hold
    numpy arrays).
    """
    with zipfile.ZipFile(pt_path) as zf:
        names = zf.namelist()
        pkl_name = next(n for n in names if n.endswith("data.pkl"))
        root = pkl_name[: -len("data.pkl")]
        blob_members = {
            n[len(root) + len("data/"):]: n
            for n in names
            if n.startswith(root + "data/")
        }

        def read_blob(key: str) -> bytes:
            return zf.read(blob_members[key])

        with zf.open(pkl_name) as f:
            return _TorchUnpickler(io.BytesIO(f.read()), read_blob).load()
