"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. Nothing
falls back to the CPU when no card is present: the CPU is used only when
the caller asks for it (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

import contextlib

import torch


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


@contextlib.contextmanager
def full_f32():
    """Full-precision float32 products and convolutions (TF32 off) for the
    enclosed block; the previous settings come back on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
