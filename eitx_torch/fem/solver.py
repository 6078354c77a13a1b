"""Batched EIT forward solves.

Port of eitx/fem/solver.py. The whole monitoring run is a few batched
library calls on the device:

  sigma (T, C)  --product-->  K (T, N, N)  --batched Cholesky-->  U (T, N, E)
                                            --gather/diff-->      V (T, E, n_meas)

with T breathing frames and E excitations solved at once (in stacks of
a bounded size where K of all T frames would not fit). Products and
solves run in full float32 (TF32 off): the reference pins ``"highest"``
matmul precision (eitx/fem/solver.py:100).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .assembly import ClassStiffness, assemble_stiffness, upload

# frames whose CG has not converged are looked for every this many
# iterations: the check waits for the device, the iterations in between do
# not (a frame that converged in between stays frozen, so nothing changes)
CG_CHECK_EVERY = 16

# the direct solve factors at most this many bytes of K(t) at once (K, its
# factor and the product's temporary live together): an lc-7 thorax's
# 3072^2 float32 system is 38 MB a frame, so 113 frames a stack
SOLVE_STACK_BYTES = 4 << 30


def _rhs_matrix(el_pos, ex_mat, n_nodes: int, dtype, device) -> torch.Tensor:
    """(N, n_exc) current injection vectors: +1 at node el_pos[a], -1 at
    el_pos[b] (pyeit natural-boundary convention). Built on the host: it
    is tiny, and building it there keeps it free of device atomics."""
    el_pos = np.asarray(el_pos)
    ex_mat = np.asarray(ex_mat)
    n_exc = ex_mat.shape[0]
    B = np.zeros((n_nodes, n_exc), dtype=np.float64)
    cols = np.arange(n_exc)
    np.add.at(B, (el_pos[ex_mat[:, 0]], cols), 1.0)
    np.add.at(B, (el_pos[ex_mat[:, 1]], cols), -1.0)
    return upload(B, dtype, device)


def _measure(u_el: torch.Tensor, meas_mat: torch.Tensor) -> torch.Tensor:
    """u_el (..., E, n_exc) electrode potentials -> (..., n_exc, n_meas)
    differences v = u[n] - u[m] for meas_mat (n_exc, n_meas, 2)=[n, m]."""
    u = u_el.mT  # (..., n_exc, E)
    lead = u.shape[:-2]
    n_idx = meas_mat[:, :, 0].expand(*lead, -1, -1)
    m_idx = meas_mat[:, :, 1].expand(*lead, -1, -1)
    return torch.gather(u, -1, n_idx) - torch.gather(u, -1, m_idx)


def _index(x, device) -> torch.Tensor:
    return upload(np.asarray(x), torch.int64, device)


def _values(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return upload(np.asarray(x), dtype, device)


def forward_solve(
    nodes, tris, cond, el_pos, ex_mat, meas_mat, n_nodes: int,
    ref_node: int = 0, device="cuda",
) -> torch.Tensor:
    """Single-frame float32 forward solve with per-element conductivity
    ``cond``.

    Returns (n_exc, n_meas) voltage differences — the pyeit
    EITForward.solve_eit equivalent for one conductivity distribution.
    """
    dev, dtype = resolve_device(device), torch.float32
    K = assemble_stiffness(_values(nodes, dtype, dev), _index(tris, dev),
                           _values(cond, dtype, dev), n_nodes)
    K[ref_node, :] = 0.0
    K[:, ref_node] = 0.0
    K[ref_node, ref_node] = 1.0
    B = _rhs_matrix(el_pos, ex_mat, n_nodes, dtype, dev)
    B[ref_node, :] = 0.0
    U = torch.cholesky_solve(B, torch.linalg.cholesky(K))  # (N, n_exc)
    return _measure(U[_index(el_pos, dev), :], _index(meas_mat, dev))


def solve_stack_frames(cs: ClassStiffness, n_frames: int) -> int:
    """Frames in each stack the direct solve factors at once: all
    ``n_frames`` where their K(t) fit in ``SOLVE_STACK_BYTES``, else the
    fewest equal stacks that fit (the last padded). A function of the
    mesh and the run's frame count alone, so every rank of a sharded run
    computes the single call's stacks."""
    per_frame = cs.n_nodes * cs.n_nodes * cs.k_class.element_size()
    cap = max(1, SOLVE_STACK_BYTES // per_frame)
    n_stacks = -(-n_frames // cap)
    return -(-n_frames // n_stacks)


def forward_solve_batched(
    cs: ClassStiffness, sigma, el_pos, ex_mat, meas_mat,
) -> torch.Tensor:
    """All breathing frames at once.

    Args:
      cs: precomputed per-class grounded stiffness matrices.
      sigma: (T, C) per-class conductivities per frame.
      el_pos/ex_mat/meas_mat: electrode nodes and protocol arrays.
    Returns:
      (T, n_exc, n_meas) voltages on ``cs``'s device.

    The frames are solved in stacks of ``solve_stack_frames(cs, T)``
    (one stack up to ``SOLVE_STACK_BYTES`` of K(t)).
    """
    sigma = _values(sigma, cs.k_class.dtype, cs.k_class.device)
    return solve_frames_in_stacks(cs, sigma, el_pos, ex_mat, meas_mat,
                                  solve_stack_frames(cs, sigma.shape[0]))


def solve_frames_in_stacks(cs: ClassStiffness, sigma: torch.Tensor, el_pos,
                           ex_mat, meas_mat, stack: int) -> torch.Tensor:
    """``forward_solve_batched``'s voltages of the frames ``sigma`` (a
    tensor on ``cs``'s device), solved in stacks of ``stack`` frames, the
    last padded by repeating its last frame. Every library call sees a
    stack of ``stack`` whichever frames fill it: on the card a batched
    call's rounding depends on the stack's size (a frame's triangular
    solves in a stack of 25 are 1.3e-6 of scale from the same frame's in
    a stack of 100; tests/torch_batch_invariance.py), not on a frame's
    place or neighbours in it. So a rank of a sharded run that solves its
    block of frames in the single call's stacks gets the single call's
    voltages."""
    dev, dt = cs.k_class.device, cs.k_class.dtype
    B = _rhs_matrix(el_pos, ex_mat, cs.n_nodes, dt, dev)
    B[cs.ref_node, :] = 0.0
    el, meas = _index(el_pos, dev), _index(meas_mat, dev)
    out = []
    for lo in range(0, sigma.shape[0], stack):
        s = sigma[lo:lo + stack]
        n = s.shape[0]
        if n < stack:
            s = torch.cat([s, s[-1:].expand(stack - n, -1)])
        out.append(_solve_stack(cs, s, B, el, meas)[:n])
    return out[0] if len(out) == 1 else torch.cat(out)


def _solve_stack(cs: ClassStiffness, sigma, B, el, meas) -> torch.Tensor:
    """Voltages (S, n_exc, n_meas) of one stack of S frames."""
    # Voltages are 1/alpha-homogeneous in conductivity: solving with
    # sigma/s and dividing the result by s keeps the Cholesky on a
    # well-scaled matrix (better f32 conditioning across frames).
    scale = sigma.mean(dim=1, keepdim=True)  # (S, 1)
    K = cs.system_matrices(sigma / scale)  # ref node + padding nodes
    L = torch.linalg.cholesky(K)
    U = torch.cholesky_solve(B.expand(K.shape[0], -1, -1), L)
    # one step of iterative refinement claws back ~an order of
    # magnitude of f32 round-off for a product + triangular solve
    U = U + torch.cholesky_solve(B - K @ U, L)
    v = _measure(U[:, el, :], meas)
    return v / scale[:, :, None]


def forward_solve_cg(
    cs: ClassStiffness, sigma, el_pos, ex_mat, meas_mat,
    tol: float = 1e-6, maxiter: int = 800,
) -> torch.Tensor:
    """CG fallback for meshes too large for dense Cholesky: the product
    keeps the dense (C, N, N) class matrices but never factorizes;
    preconditioned by the diagonal. Same (T, n_exc, n_meas) output."""
    return forward_solve_cg_info(cs, sigma, el_pos, ex_mat, meas_mat,
                                 tol=tol, maxiter=maxiter)[0]


def forward_solve_cg_info(
    cs: ClassStiffness, sigma, el_pos, ex_mat, meas_mat,
    tol: float = 1e-6, maxiter: int = 800,
):
    """``forward_solve_cg`` with what its loop did: returns (voltages,
    iterations (T,), final relative residual ||r|| / ||b|| (T,))."""
    dev, dt = cs.k_class.device, cs.k_class.dtype
    B = _rhs_matrix(el_pos, ex_mat, cs.n_nodes, dt, dev)
    B[cs.ref_node, :] = 0.0
    K = cs.system_matrices(_values(sigma, dt, dev))
    diag = torch.diagonal(K, dim1=1, dim2=2).clamp(min=1e-30)  # (T, N)
    U, iters, rs = _cg_block(K, B.expand(K.shape[0], -1, -1), diag,
                             tol, maxiter)
    v = _measure(U[:, _index(el_pos, dev), :], _index(meas_mat, dev))
    return v, iters, torch.sqrt(rs / (B * B).sum())


def _cg_block(K, B, diag, tol: float, maxiter: int):
    """Jacobi-preconditioned CG of ``jax.scipy.sparse.linalg.cg`` on each
    frame's (N, n_exc) block as ONE unknown: the inner products run over
    every entry of the block, and a frame stops when ||r||^2 <= tol^2
    ||b||^2 or at ``maxiter``, as under ``jax.vmap`` a frame stops at its
    own iteration and stays frozen. Returns (X, iterations, ||r||^2)."""

    def dot(a, b):
        return (a * b).sum(dim=(1, 2))

    atol2 = tol * tol * dot(B, B)
    x = torch.zeros_like(B)
    r = B.clone()  # b - A(x0) with x0 = 0
    z = r / diag[:, :, None]
    p = z
    gamma = dot(r, z)
    rs = dot(r, r)
    k = torch.zeros(B.shape[0], dtype=torch.int64, device=B.device)
    while bool(((rs > atol2) & (k < maxiter)).any()):
        for _ in range(CG_CHECK_EVERY):
            live = (rs > atol2) & (k < maxiter)
            Ap = K @ p
            alpha = gamma / dot(p, Ap)
            x_ = x + alpha[:, None, None] * p
            r_ = r - alpha[:, None, None] * Ap
            z_ = r_ / diag[:, :, None]
            gamma_ = dot(r_, z_)
            p_ = z_ + (gamma_ / gamma)[:, None, None] * p
            on = live[:, None, None]
            x = torch.where(on, x_, x)
            r = torch.where(on, r_, r)
            p = torch.where(on, p_, p)
            gamma = torch.where(live, gamma_, gamma)
            k = k + live.to(k.dtype)
            rs = dot(r, r)
    return x, k, rs
