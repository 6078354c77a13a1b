"""Tissue dielectric material database.

The reference (model_generator.py:214-238) mixes two sources: hardcoded
6-point frequency tables for lung / skin / bone, and CSV tables for muscle and
fat shipped alongside the code. All of that data descends from the Gabriel
tissue dielectric database (S. Gabriel, R.W. Lau, C. Gabriel, "The dielectric
properties of biological tissues: III. Parametric models for the dielectric
spectrum of tissues", Phys. Med. Biol. 41 (1996) 2271-2293).

Here muscle and fat tables are *generated* from the published 4-term
Cole-Cole parametric model instead of shipping copied CSVs; lung / skin /
bone keep the same small physical-constant tables the reference hardcodes.

Table format matches the reference throughout: a (N, 2) array of
``[frequency_hz, value]`` rows, so downstream interpolation code is shared.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

EPS0 = 8.8541878128e-12  # vacuum permittivity, F/m

# 4-term Cole-Cole parameters from Gabriel et al. 1996 (Table in paper /
# IFAC-CNR database). Columns: eps_inf, (d_eps, tau_s, alpha) x 4, sigma_ionic.
GABRIEL_COLE_COLE = {
    "muscles": {
        "eps_inf": 4.0,
        "terms": [
            (50.0, 7.234e-12, 0.10),
            (7000.0, 353.68e-9, 0.10),
            (1.2e6, 318.31e-6, 0.10),
            (2.5e7, 2.274e-3, 0.00),
        ],
        "sigma_i": 0.20,
    },
    "fat": {  # fat (not infiltrated)
        "eps_inf": 2.5,
        "terms": [
            (3.0, 7.958e-12, 0.20),
            (15.0, 15.915e-9, 0.10),
            (3.3e4, 159.15e-6, 0.05),
            (1.0e7, 15.915e-3, 0.01),
        ],
        "sigma_i": 0.01,
    },
}

# Small hardcoded tables kept verbatim from the physical constants the
# reference embeds (model_generator.py:220-227). 11111 marks an unknown
# value at 10 Hz (sentinel preserved for compatibility).
_FREQ6 = np.array([10.0, 1e2, 1e3, 1e4, 1e5, 1e6])
UNKNOWN_SENTINEL = 11111.0

_HARDCODED = {
    "lung": {
        "cond": np.stack([_FREQ6, [11111, 0.1387, 0.1231, 0.1422, 0.1821, 0.2017]], 1),
        "infl": np.stack([_FREQ6, [11111, 0.0416, 0.04335, 0.0497, 0.06424, 0.0647]], 1),
        "perm": np.stack([_FREQ6, [3.195e7, 5.426e5, 1.088e5, 30606, 11513, 1567]], 1),
    },
    "skin": {
        "cond": np.stack([_FREQ6, [0.3347, 0.365374, 0.3817, 0.43529, 0.566, 0.839]], 1),
        "perm": np.stack([_FREQ6, [1.116e5, 55953.3, 41437.3, 28898.1, 14925, 2118.79]], 1),
    },
    "bone": {
        "cond": np.stack([_FREQ6, [0.00585, 0.00586, 0.00587, 0.00589, 0.006, 0.007]], 1),
        "perm": np.stack([_FREQ6, [40140, 3824, 892, 303, 103, 30.4]], 1),
    },
}


def cole_cole(tissue: str, freq_hz: np.ndarray) -> tuple:
    """Evaluate the Gabriel 4-term Cole-Cole model.

    Returns (conductivity S/m, relative permittivity) at the given
    frequencies.  sigma = -omega * eps0 * Im(eps_hat); eps_r = Re(eps_hat).
    """
    p = GABRIEL_COLE_COLE[tissue]
    f = np.asarray(freq_hz, dtype=np.float64)
    w = 2.0 * np.pi * f
    eps_hat = np.full_like(f, p["eps_inf"], dtype=np.complex128)
    for d_eps, tau, alpha in p["terms"]:
        eps_hat = eps_hat + d_eps / (1.0 + (1j * w * tau) ** (1.0 - alpha))
    eps_hat = eps_hat + p["sigma_i"] / (1j * w * EPS0)
    sigma = -w * EPS0 * eps_hat.imag
    eps_r = eps_hat.real
    return sigma, eps_r


def generate_material_tables(
    f_min: float = 10.0, f_max: float = 1e6, points_per_decade: int = 25
) -> Dict[str, Dict[str, np.ndarray]]:
    """Build the full materials dict from the parametric model + constants.

    Shape-compatible with the reference get_materials() result:
    {tissue: {'cond': (N,2), 'perm': (N,2), [lung also 'infl']}}.
    """
    n_dec = np.log10(f_max / f_min)
    n = int(round(n_dec * points_per_decade)) + 1
    freqs = np.logspace(np.log10(f_min), np.log10(f_max), n)
    mats: Dict[str, Dict[str, np.ndarray]] = {}
    for tissue in ("muscles", "fat"):
        sigma, eps_r = cole_cole(tissue, freqs)
        mats[tissue] = {
            "cond": np.stack([freqs, sigma], axis=1),
            "perm": np.stack([freqs, eps_r], axis=1),
        }
    for tissue, tables in _HARDCODED.items():
        mats[tissue] = {k: v.copy() for k, v in tables.items()}
    return mats


def get_materials(path: Optional[str] = None) -> Dict[str, Dict[str, np.ndarray]]:
    """Materials dict; optionally overriding muscle/fat from CSV files.

    Mirrors the reference get_materials(path) contract
    (model_generator.py:214-238): if ``path`` holds
    ``data/{muscles,fat}_{c,p}.csv`` files (rows "freq,value"), those tables
    are loaded; otherwise the Cole-Cole generated tables are used.
    """
    mats = generate_material_tables()
    if path is None:
        return mats
    for mat in ("muscles", "fat"):
        for param, letter in (("cond", "c"), ("perm", "p")):
            fpath = os.path.join(path, "data", f"{mat}_{letter}.csv")
            if os.path.exists(fpath):
                rows = []
                with open(fpath) as fh:
                    for line in fh:
                        s = line.strip().split(",")
                        if len(s) >= 2:
                            rows.append([float(s[0]), float(s[1])])
                if rows:
                    mats[mat][param] = np.array(rows)
    return mats


def interp_at_freq(
    table: np.ndarray, freq: float, compat_reference_interp: bool = False
) -> float:
    """Value of a (N,2) [freq, value] table at ``freq``.

    Default: proper piecewise-linear interpolation (log-x linear-y), skipping
    UNKNOWN_SENTINEL rows, clamped linear extrapolation at the ends.

    ``compat_reference_interp=True`` reproduces the reference's
    get_material_data_freq (femm_api.py:50-74) exactly, including its quirky
    bracket choice: it picks the *first row with f >= freq* as the left
    endpoint of the interpolation segment, so e.g. 50 kHz on a decade grid is
    extrapolated down from the [1e5, 1e6] segment instead of interpolated in
    [1e4, 1e5]. That behaviour is load-bearing for bit-parity with reference
    voltage datasets.
    """
    data = np.asarray(table, dtype=np.float64)
    if compat_reference_interp:
        if freq < data[0, 0]:
            i1, i2 = (1, 2) if data[0, 1] == UNKNOWN_SENTINEL else (0, 1)
        elif freq > data[-1, 0]:
            # The reference crashes here (idx2 unbound); we extrapolate from
            # the last segment instead of reproducing the NameError.
            i1, i2 = -2, -1
        else:
            i1 = int(np.where(data[:, 0] >= freq)[0][0])
            i2 = i1 + 1
            if i2 >= data.shape[0]:
                i1, i2 = data.shape[0] - 2, data.shape[0] - 1
        x1, y1 = data[i1]
        x2, y2 = data[i2]
        return float(y1 + (y2 - y1) * (freq - x1) / (x2 - x1))

    valid = data[:, 1] != UNKNOWN_SENTINEL
    d = data[valid]
    logf = np.log10(max(freq, 1e-12))
    logx = np.log10(d[:, 0])
    return float(np.interp(logf, logx, d[:, 1]))


def tissue_conductivities(
    materials: Dict[str, Dict[str, np.ndarray]],
    freq: float,
    class_names: Dict[int, str],
    compat_reference_interp: bool = False,
) -> Dict[str, float]:
    """{class_name: conductivity} at ``freq`` for every class in the map.

    Mirrors class_to_cond (synthetic_datasets_generator.py:110-123).
    """
    out = {}
    for _, name in class_names.items():
        out[name] = interp_at_freq(
            materials[name]["cond"], freq, compat_reference_interp
        )
    return out
