"""Published peaks of the cards the benchmark runs on.

Copied from ``bench_torch.py`` ``PEAKS`` (lines 158-163) and
``card_name_and_limit`` (lines 354-360): NVIDIA's H100 data sheet, dense
rates without sparsity, at the full power limit. The float32 rate is the
one outside the tensor cores: TF32 is off on every path of the port. The
card's power limit is read beside every share, since a card set below
700 W runs slower under load.
"""

from __future__ import annotations

import subprocess

# card name fragment -> (bf16 FLOP/s, float32 FLOP/s, HBM bytes/s)
PEAKS = {
    "H100 80GB HBM3": (989.4e12, 66.9e12, 3.35e12),  # SXM5
    "H100 PCIe": (756.5e12, 51.2e12, 2.0e12),
}


def card_peaks(name: str):
    """(bf16, f32, bytes/s) of the card called ``name``, or None."""
    for tag, peaks in PEAKS.items():
        if tag in name:
            return peaks
    return None


def card_name_and_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or ''."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else ""
