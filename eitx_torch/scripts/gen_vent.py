"""Generate the packaged recorded-style ventilation trace (data/vent.csv).

Port of eitx/scripts/gen_vent.py. It is numpy only (no device, so no
``--device``) and writes the same bytes as eitx's, which are the bytes of
the committed eitx_torch/data/vent.csv.

The reference ships a real 2,840-row breathing capture
(data/vent.csv, loaded by get_spirometry_ref at
synthetic_datasets_generator.py:18-34). Patient data cannot be copied, so
the package ships a REPRODUCIBLY GENERATED capture with the statistical
texture of a real recording: cycle-to-cycle period jitter, amplitude
variability, inspiration/expiration asymmetry, baseline wander, and
sensor noise. Regenerate with  python -m eitx_torch.scripts.gen_vent .
"""

from __future__ import annotations

import os

import numpy as np


def generate_recorded_style_trace(
    n_rows: int = 2840,
    fs: float = 25.0,
    mean_period_s: float = 4.3,
    seed: int = 2026,
) -> np.ndarray:
    """(n_rows, 2) [time_s, volume] recorded-style ventilation trace."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_rows) / fs
    # phase accumulates with per-cycle period jitter (~8% CV)
    phase = np.zeros(n_rows)
    period = mean_period_s * (1 + 0.08 * rng.standard_normal())
    next_cycle_t = period
    amp = 1.0
    amps = np.zeros(n_rows)
    ph = 0.0
    for i in range(n_rows):
        if t[i] >= next_cycle_t:
            period = mean_period_s * (1 + 0.08 * rng.standard_normal())
            next_cycle_t += period
            amp = 1.0 + 0.12 * rng.standard_normal()
        ph += 2 * np.pi / (period * fs)
        phase[i] = ph
        amps[i] = amp
    # asymmetric breath shape: faster inspiration, slower expiration
    base = np.sin(phase) + 0.22 * np.sin(2 * phase - 0.9)
    x = amps * base
    # baseline wander (two slow components) + occasional deeper breath
    x += 0.15 * np.sin(2 * np.pi * 0.013 * t + 1.2)
    x += 0.08 * np.sin(2 * np.pi * 0.031 * t + 0.3)
    sigh = np.exp(-0.5 * ((t - t[-1] * 0.62) / 1.8) ** 2)
    x += 0.5 * sigh
    x += 0.015 * rng.standard_normal(n_rows)  # sensor noise
    # normalize to [0, 1] like a volume fraction
    x = (x - x.min()) / (x.max() - x.min())
    return np.stack([t, x], axis=1)


def main(out_path: str = None) -> str:
    out_path = out_path or os.path.join(
        os.path.dirname(__file__), "..", "data", "vent.csv"
    )
    trace = generate_recorded_style_trace()
    with open(out_path, "w") as fh:
        for ts, v in trace:
            fh.write(f"{ts:.4f},{v:.6f}\n")
    return os.path.abspath(out_path)


if __name__ == "__main__":
    print(main())
