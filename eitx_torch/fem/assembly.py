"""Batched P1 finite-element stiffness assembly for 2-D conduction.

Port of eitx/fem/assembly.py. The stiffness matrix is linear in
per-class conductivity,

    K(t) = sum_c sigma_c(t) * K_c,

so one grounded K_c per tissue class is assembled once per mesh and every
breathing frame's system matrix is a (C,) x (C, N, N) contraction.

The scatter-add is deterministic on every device without a process-wide
flag: ``scatter_sum_fixed_order`` sorts the entries by their target (a
stable sort), sums each run of equal targets by a segmented scan of fixed
shape, and writes each run's total once. No atomics race and no host wait
is needed, so two runs assemble bit-identical matrices (the byte-equal
``.dat`` check relies on it) and concurrent requests need no lock around
the assembly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.timing import count, span


def upload(x: np.ndarray, dtype, device) -> torch.Tensor:
    """The host array ``x`` as a tensor on ``device``; the bytes that go
    to a card count as ``eitx.fem.upload_bytes``."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if t.is_cuda:
        count("eitx.fem.upload_bytes", t.numel() * t.element_size())
    return t


def scatter_sum_fixed_order(flat: torch.Tensor, vals: torch.Tensor,
                            size: int) -> torch.Tensor:
    """(C, size) with column f the sum of ``vals`` (C, E) over the entries
    whose ``flat`` (E,) target is f, every sum taken in one fixed order.

    The entries are sorted by target (stable), so each target's entries
    form a run. A segmented inclusive scan doubles its reach each step
    (Hillis-Steele: entry i adds entry i - d when both lie in one run), so
    after ceil(log2 E) steps the last entry of a run holds the run's total;
    that entry alone writes it, the others write to a discarded column.
    Every step has the same shape whatever the mesh, so nothing waits for
    the device."""
    order = torch.sort(flat, stable=True).indices
    f = flat[order]
    v = vals[:, order]
    e = f.shape[0]
    pos = torch.arange(e, device=f.device)
    start = torch.searchsorted(f, f)  # first position of each entry's run
    d = 1
    while d < e:
        reach = (pos[d:] - d >= start[d:])[None]
        v = torch.cat([v[:, :d], v[:, d:] + torch.where(reach, v[:, :-d], 0.0)],
                      dim=1)
        d *= 2
    last = torch.ones(e, dtype=torch.bool, device=f.device)
    last[:-1] = f[1:] != f[:-1]
    dst = torch.where(last, f, size)
    out = torch.zeros((vals.shape[0], size + 1), dtype=vals.dtype,
                      device=vals.device)
    out.index_copy_(1, dst, v)
    return out[:, :size]


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
    # the cyclic shifts i+1 and i+2 as rolls: indexing a CUDA tensor with a
    # Python list copies the list to the card and waits for it
    b = y.roll(-1, 1) - y.roll(1, 1)  # (M, 3)
    c = x.roll(1, 1) - x.roll(-1, 1)  # (M, 3)
    area2 = x[:, 0] * b[:, 0] + x[:, 1] * b[:, 1] + x[:, 2] * b[:, 2]
    area = 0.5 * area2.abs()
    valid = area > 1e-12
    safe_area = torch.where(valid, area, torch.ones_like(area))
    ke = (b[:, :, None] * b[:, None, :] + c[:, :, None] * c[:, None, :]) / (
        4.0 * safe_area[:, None, None]
    )
    ke = torch.where(valid[:, None, None], ke, torch.zeros_like(ke))
    return ke, area


def assemble_stiffness(
    nodes: torch.Tensor, tris: torch.Tensor, cond: torch.Tensor, n_nodes: int
) -> torch.Tensor:
    """Dense global stiffness for one per-element conductivity vector:
    cond (M,) -> (N, N)."""
    return assemble_class_stiffness(nodes, tris, cond[:, None], n_nodes)[0]


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
    K = scatter_sum_fixed_order(flat, vals.reshape(n_cls, -1),
                                n_nodes * n_nodes)
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
        device = resolve_device(device)
        with span("eitx.fem.assembly", device):
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

            nodes_t = upload(nodes, dtype, device)
            tris_t = upload(tris, torch.int64, device)
            cls_t = upload(elem_class, None, device)
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
                diag_fix=upload(diag_fix, dtype, device),
                ref_node=ref_node,
                n_nodes=n_pad,
                n_real_nodes=n_real,
                n_classes=n_classes,
                tris_host=tris,
                elem_class_host=elem_class,
                grounded=ground_ref,
            )

    def system_matrices(self, sigma: torch.Tensor) -> torch.Tensor:
        """K(t) for per-class conductivities sigma (T, C) -> (T, N, N)."""
        K = torch.tensordot(sigma.to(self.k_class.dtype), self.k_class,
                            dims=([1], [0]))
        return K + torch.diag(self.diag_fix)[None]
