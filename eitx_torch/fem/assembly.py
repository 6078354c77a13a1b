"""Batched P1 finite-element stiffness assembly for 2-D conduction.

Port of eitx/fem/assembly.py. The stiffness matrix is linear in
per-class conductivity,

    K(t) = sum_c sigma_c(t) * K_c,

so one grounded K_c per tissue class is assembled once per mesh and every
breathing frame's system matrix is a (C,) x (C, N, N) contraction.

The scatter-add is deterministic on CUDA: ``index_put_(accumulate=True)``
runs under ``torch.use_deterministic_algorithms(True)``, which sorts the
indices and sums each run of equal indices in a fixed order instead of
racing atomics. Two runs therefore assemble bit-identical matrices, which
the byte-equal ``.dat`` check relies on.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch


@contextlib.contextmanager
def deterministic_algorithms():
    """Scoped ``torch.use_deterministic_algorithms(True)``."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def element_geometry(nodes: torch.Tensor, tris: torch.Tensor):
    """Per-element local stiffness geometry factors.

    For linear triangles with vertices p0,p1,p2:
      b_i = y_{i+1} - y_{i+2},  c_i = x_{i+2} - x_{i+1}  (cyclic)
      ke_ij = (b_i b_j + c_i c_j) / (4 A)
    Returns (ke (M,3,3) with unit conductivity, area (M,)).

    Degenerate (near-zero-area) elements — used as static-shape padding —
    contribute an all-zero ke instead of dividing by zero.
    """
    p = nodes[tris]  # (M, 3, 2)
    x = p[..., 0]
    y = p[..., 1]
    roll1 = [1, 2, 0]
    roll2 = [2, 0, 1]
    b = y[:, roll1] - y[:, roll2]  # (M, 3)
    c = x[:, roll2] - x[:, roll1]  # (M, 3)
    area2 = x[:, 0] * b[:, 0] + x[:, 1] * b[:, 1] + x[:, 2] * b[:, 2]
    area = 0.5 * area2.abs()
    valid = area > 1e-12
    safe_area = torch.where(valid, area, torch.ones_like(area))
    ke = (b[:, :, None] * b[:, None, :] + c[:, :, None] * c[:, None, :]) / (
        4.0 * safe_area[:, None, None]
    )
    ke = torch.where(valid[:, None, None], ke, torch.zeros_like(ke))
    return ke, area


def assemble_class_stiffness(
    nodes: torch.Tensor, tris: torch.Tensor, weights: torch.Tensor,
    n_nodes: int,
) -> torch.Tensor:
    """Dense global stiffness for C per-element weight vectors at once:
    weights (M, C) -> (C, N, N)."""
    ke, _ = element_geometry(nodes, tris)
    n_cls = weights.shape[1]
    vals = weights.T[:, :, None, None] * ke[None]  # (C, M, 3, 3)
    ii = tris[:, :, None].expand(-1, 3, 3)
    jj = tris[:, None, :].expand(-1, 3, 3)
    flat = (ii * n_nodes + jj).reshape(-1)
    K = torch.zeros((n_cls, n_nodes * n_nodes), dtype=vals.dtype,
                    device=vals.device)
    cls_idx = torch.arange(n_cls, device=vals.device)[:, None].expand(
        -1, flat.shape[0])
    with deterministic_algorithms():
        K.index_put_(
            (cls_idx.reshape(-1), flat.repeat(n_cls)),
            vals.reshape(-1),
            accumulate=True,
        )
    return K.reshape(n_cls, n_nodes, n_nodes)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class ClassStiffness:
    """Per-tissue-class grounded stiffness matrices.

    k_class: (C, N, N) — rows/cols of the reference node zeroed per class.
    diag_fix: (N,) with 1.0 at the reference node and at every padding node
    (isolated rows that would otherwise make K singular), added back after
    the per-frame weighted sum.

    ``pad_nodes_to`` / ``pad_elems_to`` round the node/element counts up
    to a bucket multiple, as the reference does; padding elements are
    degenerate triangles on node 0 with class -1 (no class), padding nodes
    are isolated and carry a unit diagonal.
    """

    k_class: torch.Tensor
    diag_fix: torch.Tensor
    ref_node: int
    n_nodes: int  # padded size
    n_real_nodes: int
    n_classes: int
    # host copies of the padded connectivity: the spectral solver derives
    # per-class node sets (lung-subspace indices) from these without a
    # device->host readback
    tris_host: np.ndarray = None
    elem_class_host: np.ndarray = None
    grounded: bool = True

    @classmethod
    def build(
        cls,
        nodes: np.ndarray,
        tris: np.ndarray,
        elem_class: np.ndarray,
        n_classes: int,
        ref_node: int = 0,
        dtype=torch.float32,
        pad_nodes_to: int = 1,
        pad_elems_to: int = 1,
        ground_ref: bool = True,
        device="cuda",
    ) -> "ClassStiffness":
        nodes = np.asarray(nodes, dtype=np.float64)
        tris = np.asarray(tris, dtype=np.int64)
        elem_class = np.asarray(elem_class, dtype=np.int64)
        n_real = nodes.shape[0]
        n_pad = _round_up(n_real, max(pad_nodes_to, 1))
        m_pad = _round_up(tris.shape[0], max(pad_elems_to, 1))
        if n_pad > n_real:
            nodes = np.vstack([nodes, np.zeros((n_pad - n_real, 2))])
        if m_pad > tris.shape[0]:
            extra = m_pad - tris.shape[0]
            # degenerate (zero-area) elements on node 0: zero contribution
            tris = np.vstack([tris, np.zeros((extra, 3), dtype=np.int64)])
            # class -1 matches no class: its one-hot row is all zero
            elem_class = np.concatenate(
                [elem_class, np.full((extra,), -1, dtype=np.int64)]
            )

        nodes_t = torch.as_tensor(nodes, dtype=dtype, device=device)
        tris_t = torch.as_tensor(tris, dtype=torch.int64, device=device)
        cls_t = torch.as_tensor(elem_class, device=device)
        onehot = (
            cls_t[:, None] == torch.arange(n_classes, device=device)[None]
        ).to(dtype)  # (M, C)
        k = assemble_class_stiffness(nodes_t, tris_t, onehot, n_pad)
        diag_fix = np.zeros((n_pad,), dtype=np.float64)
        if ground_ref:
            # ground the reference node inside each class matrix
            # (point-electrode gauge)
            k[:, ref_node, :] = 0.0
            k[:, :, ref_node] = 0.0
            diag_fix[ref_node] = 1.0
        diag_fix[n_real:] = 1.0
        return cls(
            k_class=k,
            diag_fix=torch.as_tensor(diag_fix, dtype=dtype, device=device),
            ref_node=ref_node,
            n_nodes=n_pad,
            n_real_nodes=n_real,
            n_classes=n_classes,
            tris_host=tris,
            elem_class_host=elem_class,
            grounded=ground_ref,
        )
