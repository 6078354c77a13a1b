"""Breathing / spirometry models and lung-conductivity schedules.

Reference behaviour being matched (synthetic_datasets_generator.py):
  - make_spirometry (:36-48): one inspiration sampled at N_points over
    [0, 60/N_resp], 0.5*sin(2*pi*f*t + 270deg) + 0.5 in [0, 1].
  - filt_FFT (:50-83): spectral band filters by zeroing FFT bins.
  - spirometry_to_conuctivity (:85-108): linear map from air volume to lung
    conductivity between deflated and inflated values at the problem
    frequency.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from .materials import interp_at_freq


def make_spirometry(n_resp: float, n_points: int) -> np.ndarray:
    """Synthetic single-inspiration spirometry signal.

    Returns an (n_points, 2) array of [time_s, volume] with volume in [0, 1].
    The reference uses 3.1415 for pi (synthetic_datasets_generator.py:47); we
    use math.pi — the difference is < 3e-5 of a cycle.
    """
    t = np.linspace(0.0, 60.0 / n_resp, n_points)
    x = 0.5 * np.sin(2.0 * math.pi * (n_resp / 60.0) * t + math.radians(270)) + 0.5
    return np.stack([t, x], axis=1)


def synthetic_ventilation(
    duration_s: float = 120.0,
    fs: float = 24.0,
    n_resp: float = 12.0,
    noise: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """Realistic recorded-like ventilation trace: fundamental + harmonics +
    slow drift + sensor noise. Stand-in for the reference's vent.csv capture
    (get_spirometry_ref, synthetic_datasets_generator.py:18-34)."""
    rng = np.random.default_rng(seed)
    t = np.arange(0.0, duration_s, 1.0 / fs)
    f0 = n_resp / 60.0
    x = (
        0.45 * np.sin(2 * np.pi * f0 * t + math.radians(270))
        + 0.06 * np.sin(2 * np.pi * 2 * f0 * t + 0.7)
        + 0.02 * np.sin(2 * np.pi * 3 * f0 * t + 1.9)
        + 0.03 * np.sin(2 * np.pi * 0.02 * t)
    )
    x = x - x.min()
    x = x / x.max()
    x = x + noise * rng.standard_normal(t.shape)
    return np.stack([t, x], axis=1)


def load_ventilation_csv(fname: str) -> np.ndarray:
    """Load a 2-column "time,volume" CSV recording (reference :18-34)."""
    rows = []
    with open(fname) as fh:
        for line in fh:
            s = line.split(",")
            if len(s) >= 2:
                rows.append([float(s[0]), float(s[1])])
    return np.array(rows)


def get_spirometry_ref(path: str = None) -> np.ndarray:
    """The packaged ventilation recording (reference get_spirometry_ref,
    synthetic_datasets_generator.py:18-34 loading data/vent.csv). eitx ships
    a reproducibly generated recorded-style capture of the same length
    (eitx/data/vent.csv, see scripts/gen_vent.py)."""
    import os

    if path is None:
        path = os.path.join(os.path.dirname(__file__), "..", "data",
                            "vent.csv")
    return load_ventilation_csv(path)


def recorded_schedule(
    n_points: int,
    freq: float,
    materials: Dict,
    csv_path: str = None,
    lowpass_hz: float = 0.8,
    compat_reference_interp: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Conductivity schedule driven by a RECORDED ventilation trace.

    Reference recipe for real spirometry: FFT low-pass to strip sensor
    noise (filt_FFT, :50-83), then the linear volume->conductivity map
    (:85-108). The cleaned trace is resampled to ``n_points`` frames.
    Returns (spirometry (N,2), cond_schedule (N,2)).
    """
    trace = get_spirometry_ref(csv_path)
    t, x = trace[:, 0], trace[:, 1]
    fs = 1.0 / float(np.median(np.diff(t)))
    x = fft_filter("low", fs, lowpass_hz, x)
    ti = np.linspace(t[0], t[-1], n_points)
    xi = np.interp(ti, t, x)
    sample = np.stack([ti, xi], axis=1)
    condspir = spirometry_to_conductivity(
        sample, freq, materials, xi, compat_reference_interp
    )
    return sample, condspir


def fft_filter(typ: str, fps: float, fc, data: np.ndarray) -> np.ndarray:
    """Spectral filter by zeroing FFT amplitude bins (reference :50-83).

    typ in {'low', 'high', 'bypass', 'reject'}; fc is a scalar cut frequency
    or a (lo, hi) tuple for bypass/reject. Returns the real part of the
    rebuilt signal.
    """
    data = np.asarray(data, dtype=np.float64)
    n = data.shape[0]
    f = np.r_[-n / 2 : n / 2 - 1] * fps / n
    ys = np.fft.fftshift(np.fft.fft(data))
    if typ == "low":
        idx = np.where(np.logical_or(f <= -fc, f >= fc))
    elif typ == "high":
        idx = np.where(np.logical_and(f >= -fc, f <= fc))
    elif typ == "bypass":
        a = np.logical_and(np.logical_or(f >= fc[1], f <= fc[0]), f >= 0)
        b = np.logical_and(np.logical_or(f <= -fc[1], f >= fc[0]), f < 0)
        idx = np.where(np.logical_or(a, b))
    elif typ == "reject":
        a = np.logical_and(np.logical_or(f <= fc[1], f >= fc[0]), f >= 0)
        b = np.logical_and(np.logical_or(f >= -fc[1], f <= fc[0]), f < 0)
        idx = np.where(np.logical_or(a, b))
    else:
        raise ValueError(f"Unknown filter type: {typ}")
    ys[idx] = 0.0 + 0.0j
    return np.fft.ifft(np.fft.ifftshift(ys)).real


def spirometry_to_conductivity(
    sample: np.ndarray,
    freq: float,
    materials: Dict,
    spir: np.ndarray,
    compat_reference_interp: bool = False,
) -> np.ndarray:
    """Lung conductivity over time from a spirometry sample.

    Linear map: max volume -> inflated conductivity, min volume -> deflated
    conductivity, both evaluated at the problem frequency
    (reference :85-108). ``spir`` sets the volume range (the live pipeline
    passes 1.5x the sample amplitude, reference :327).
    """
    spir = np.asarray(spir)
    sp = spir[:, 1] if spir.ndim == 2 else spir
    if spir.ndim > 2:
        raise ValueError("unsupported spirometry data shape")
    def_c = interp_at_freq(materials["lung"]["cond"], freq, compat_reference_interp)
    inf_c = interp_at_freq(materials["lung"]["infl"], freq, compat_reference_interp)
    spiramp = sp.max() - sp.min()
    condamp = def_c - inf_c
    out = np.array(sample, dtype=np.float64, copy=True)
    out[:, 1] = (-sample[:, 1] + sp.max()) * (condamp / spiramp) + inf_c
    return out


def conductivity_schedule(
    n_spir: float,
    n_points: int,
    freq: float,
    materials: Dict,
    volume_scale: float = 1.5,
    compat_reference_interp: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Default live-pipeline schedule: synthetic spirometry scaled by 1.5,
    mapped to lung conductivity (reference :326-328).

    Returns (spirometry (N,2), cond_schedule (N,2)).
    """
    dataf = make_spirometry(n_spir, n_points)
    spir = dataf[:, 1] * volume_scale
    condspir = spirometry_to_conductivity(
        dataf, freq, materials, spir, compat_reference_interp
    )
    return dataf, condspir
