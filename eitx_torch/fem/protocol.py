"""Stimulation / measurement protocols for EIT.

Static-shape reimplementation of the adjacent (Sheffield) protocol the
reference builds through pyeit (``protocol.create(16, dist_exc=1,
step_meas=1, parser_meas="std")`` at synthetic_datasets_generator.py:331):

  - excitation e: current +1 into electrode a=e, -1 out of b=(e+dist)%E
  - measurements: pairs (n, m) with n=(m+step)%E, v = u[n] - u[m], skipping
    any pair touching a current-carrying electrode ("std"/"fmmu" parsers),
    or keeping all pairs ("meas_current").
  - parser "fmmu"/"rotate_meas" rotates the measurement start to electrode a.

Every excitation keeps the same number of measurements (the pattern is a
rotation), so the measurement matrix is a dense static (n_exc, n_meas, 2)
int array — XLA-friendly gathers, no ragged shapes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Protocol:
    n_el: int
    ex_mat: np.ndarray  # (n_exc, 2) [a, b] injection electrode indices
    meas_mat: np.ndarray  # (n_exc, n_meas, 2) [n, m]; v = u[n] - u[m]

    @property
    def n_exc(self) -> int:
        return int(self.ex_mat.shape[0])

    @property
    def n_meas(self) -> int:
        return int(self.meas_mat.shape[1])


def create_protocol(
    n_el: int = 16,
    dist_exc: int = 1,
    step_meas: int = 1,
    parser_meas: str = "std",
) -> Protocol:
    ex_mat = np.array(
        [[i, (i + dist_exc) % n_el] for i in range(n_el)], dtype=np.int32
    )
    keep_current = parser_meas == "meas_current"
    rotate = parser_meas in ("fmmu", "rotate_meas")

    rows = []
    for a, b in ex_mat:
        i0 = a if rotate else 0
        m = (i0 + np.arange(n_el)) % n_el
        n = (m + step_meas) % n_el
        pairs = np.stack([n, m], axis=1)
        if not keep_current:
            keep = (m != a) & (m != b) & (n != a) & (n != b)
            pairs = pairs[keep]
        rows.append(pairs)
    counts = {r.shape[0] for r in rows}
    if len(counts) != 1:
        raise ValueError(
            f"ragged measurement pattern (counts={sorted(counts)}); "
            "static protocol requires equal measurements per excitation"
        )
    meas_mat = np.stack(rows).astype(np.int32)
    return Protocol(n_el=n_el, ex_mat=ex_mat, meas_mat=meas_mat)


def abs_to_diff(v: np.ndarray, n_el: int) -> np.ndarray:
    """Neighbour voltage differences from absolute electrode voltages.

    FEMM-path parity (synthetic_datasets_generator.py:144-162): for each
    index i, diff = v[i] - v[i+1], wrapping inside each block of n_el.
    """
    v = np.asarray(v)
    # vectorized: blocks of n_el along the LAST axis (equals the
    # reference's axis-0 walk for the 1-D arrays it is applied to), and
    # generalizes to (T, n_proj, n_el) monitoring stacks
    blocks = v.reshape(*v.shape[:-1], -1, n_el)
    return (blocks - np.roll(blocks, -1, axis=-1)).reshape(v.shape)
