"""``resolve_device`` and the float32 settings of eitx_torch/core/device.py
as of commit 82a40b4: TF32 off and cuDNN's deterministic algorithms only,
set for the process when this module is imported, as the port sets them."""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
