"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. Nothing
falls back to the CPU when no card is present: the CPU is used only when
the caller asks for it (the tests pass ``device="cpu"``).

The port's float32 paths never run in TF32, and its convolutions run only
cuDNN's deterministic algorithms: importing this module (every entry point
does) sets both for the process, once. cuDNN's other gradient algorithms
add in no fixed order, so two train steps from one state differed on the
card (``tests/torch_train_repro.py``); with this setting the same seed
gives the same run, as eitx's does. Serving computes what it computed
without it: the same labels and ``.dat`` bytes on the card. A setting that
each block switched on and off would race between the service's
concurrent requests; ``torch.use_deterministic_algorithms`` is not used:
it fills every ``torch.empty`` and refuses ops the port runs.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False


def resolve_device(device="cuda") -> torch.device:
    """``device`` -> torch.device; raises if a CUDA device is asked for on
    a machine without one."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


# numpy types torch has no arithmetic for, and the type that holds them
_WIDER = {np.dtype(np.uint16): np.int32, np.dtype(np.uint32): np.int64}


def to_device(x, device="cuda") -> torch.Tensor:
    """A tensor as it is (wherever it lives); anything else through numpy
    to ``device``. Unsigned 16- and 32-bit arrays (a DICOM pixel array may
    be uint16) are widened on the host before the upload."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype in _WIDER:
        arr = arr.astype(_WIDER[arr.dtype])
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # a view of a file's bytes: torch wants its own
        arr = arr.copy()
    return torch.from_numpy(arr).to(resolve_device(device))
