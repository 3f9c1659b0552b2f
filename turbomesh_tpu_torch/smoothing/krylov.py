"""Krylov solvers and batched tridiagonal line solves.

Replaces the reference's GMRES(30)+ILU0 / BiCGStab machinery (GMRES.zig,
BiCGStab.zig). The device solver is flexible restarted GMRES over torch
tensors: the Arnoldi process, modified Gram-Schmidt and the Givens
least-squares solve all stay on the tensors' device, and the only host
synchronisation is the stop test, once per restart cycle.

Counterpart of turbomesh_tpu/smoothing/krylov.py. ``numpy_gmres`` and
``numpy_bicgstab`` are the host backends of ``system.SparseSystem``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..profiling import span

log = logging.getLogger("turbomesh.krylov")


def _warn_nonconverged(name: str, iters: int, resid: float, tol: float):
    """Reference behavior: a stalled Krylov solve is a loud warning, not a
    silent return (GMRES.zig:422, BiCGStab.zig:369)."""
    log.warning("%s solve did not converge: iter=%d, residual=%.3e (tol %.3e)",
                name, iters, resid, tol)


def _nonzero(v):
    """v with exact zeros replaced by 1 (safe divisor)."""
    return torch.where(v == 0, torch.ones_like(v), v)


def fgmres_one_cycle(A, b, M_inv, dot, m, x):
    """One FGMRES(m) restart cycle from iterate ``x``: Arnoldi over the
    preconditioned directions Z, modified Gram-Schmidt over i <= k,
    Givens least-squares, update. Returns (x1, r1, ||r1||) with the norm
    as a device scalar (no host synchronisation). The directions go into
    one (m, ...) tensor as they come, which the update contracts as it
    stands: no stacked copy of them at the cycle's end."""
    r = b - A(x)
    beta = torch.sqrt(dot(r, r))
    V = [r / _nonzero(beta)]
    Z = torch.empty((m,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
    for k in range(m):
        Z[k] = M_inv(V[k])
        w = A(Z[k])
        for i in range(k + 1):
            hik = dot(w, V[i])
            H[i, k] = hik
            w = w - hik * V[i]
        hk1 = torch.sqrt(dot(w, w))
        H[k + 1, k] = hk1
        V.append(w / _nonzero(hk1))
    e1 = torch.zeros(m + 1, dtype=b.dtype, device=b.device)
    e1[0] = beta
    y = _lsq_givens(H, e1, m)
    x1 = x + torch.tensordot(y, Z, dims=1)
    r1 = b - A(x1)
    return x1, r1, torch.sqrt(dot(r1, r1))


def restarted_fgmres(A, b, M_inv, dot, rtol, atol, restart, max_restarts,
                     w2=None, tol2=None, return_restarts=False):
    """Flexible restarted GMRES (FGMRES, Saad 1993): stores the
    preconditioned directions Z_k = M_inv(V_k) and forms the update from
    Z, so M_inv may vary between applications — required when the
    preconditioner runs in a lower precision than the Krylov iteration.

    Optional secondary stop test: when ``w2``/``tol2`` are given, the
    iteration also stops once ``||w2 * r|| <= tol2`` — used to pair the
    equilibrated (row-relative) criterion with the reference's plain
    residual criterion, whichever is met first.

    ``rtol``/``atol``/``tol2`` may be floats or device scalars. The stop
    test reads one boolean per restart cycle on the host. Returns
    (x, primary_residual_norm) with the norm as a device scalar, and with
    ``return_restarts`` also the restart cycles run (an int).
    """
    bnorm = torch.sqrt(dot(b, b))
    tol = torch.clamp(rtol * bnorm, min=atol)
    x = torch.zeros_like(b)
    rn = torch.full((), float("inf"), dtype=b.dtype, device=b.device)
    i = 0
    while i < max_restarts:
        with span("fgmres.cycle"):
            x, r, rn = fgmres_one_cycle(A, b, M_inv, dot, restart, x)
        i += 1
        live = rn > tol
        if w2 is not None:
            rn2 = torch.sqrt(dot(w2 * r, w2 * r))
            live = torch.logical_and(live, rn2 > tol2)
        with span("fgmres.stop_test"):
            live = bool(live)
        if not live:
            break
    if return_restarts:
        return x, rn, i
    return x, rn


def _lsq_givens(H, g, m):
    """Least squares min ||H y - g|| for Hessenberg H (m+1, m) via Givens
    rotations + back substitution, on H's device."""
    R = H.clone()
    g = g.clone()
    one = torch.ones((), dtype=H.dtype, device=H.device)
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    for k in range(m):
        a, b_ = R[k, k], R[k + 1, k]
        r = torch.sqrt(a * a + b_ * b_)
        safe = torch.where(r == 0, one, r)
        c = torch.where(r == 0, one, a / safe)
        s = torch.where(r == 0, zero, b_ / safe)
        Rk = c * R[k] + s * R[k + 1]
        Rk1 = -s * R[k] + c * R[k + 1]
        R[k] = Rk
        R[k + 1] = Rk1
        gk = c * g[k] + s * g[k + 1]
        gk1 = -s * g[k] + c * g[k + 1]
        g[k] = gk
        g[k + 1] = gk1
    y = torch.zeros(m, dtype=H.dtype, device=H.device)
    for k in range(m - 1, -1, -1):
        num = g[k] - torch.dot(R[k, k + 1:m], y[k + 1:m])
        y[k] = num / torch.where(R[k, k] == 0, one, R[k, k])
    return y


def thomas(dl, d, du, rhs):
    """Batched tridiagonal solve along the LAST-but-one axis of rhs.

    dl, d, du: (..., M) sub/main/super diagonals (dl[...,0] and du[...,M-1]
    ignored); rhs: (..., M, C). Sequential Thomas elimination over M, each
    step one vector op over the batch. Zero denominators become 1."""
    Mn = d.shape[-1]
    cps, dps = [], []
    cp_prev = torch.zeros_like(d[..., 0])
    dp_prev = torch.zeros_like(rhs[..., 0, :])
    for k in range(Mn):
        dl_k = dl[..., k]
        denom = d[..., k] - dl_k * cp_prev
        denom = _nonzero(denom)
        cp_prev = du[..., k] / denom
        dp_prev = (rhs[..., k, :] - dl_k[..., None] * dp_prev) / denom[..., None]
        cps.append(cp_prev)
        dps.append(dp_prev)
    xs = [None] * Mn
    x_next = dps[-1]
    xs[-1] = x_next
    for k in range(Mn - 2, -1, -1):
        x_next = dps[k] - cps[k][..., None] * x_next
        xs[k] = x_next
    return torch.stack(xs, dim=-2)


def tridiag_pcr(dl, d, du, rhs):
    """Parallel cyclic reduction tridiagonal solve along the last-but-one
    axis of rhs; same signature/semantics as thomas(). Out-of-range
    neighbors are treated as identity rows (a=c=0, b=1, d=0)."""
    n = d.shape[-1]
    steps = max(1, (max(n, 2) - 1).bit_length())
    idx = torch.arange(n, device=d.device)
    idx_r = idx[:, None]

    def shift(arr, s, fill):
        rolled = torch.roll(arr, s, dims=-1)
        valid = (idx - s >= 0) & (idx - s < n)
        return torch.where(valid, rolled, torch.full_like(rolled, fill))

    def shift_r(arr, s, fill):
        rolled = torch.roll(arr, s, dims=-2)
        valid = (idx_r - s >= 0) & (idx_r - s < n)
        return torch.where(valid, rolled, torch.full_like(rolled, fill))

    a, b, c, r = dl, d, du, rhs
    s = 1
    for _ in range(steps):
        a_m, b_m, c_m = shift(a, s, 0.0), shift(b, s, 1.0), shift(c, s, 0.0)
        r_m = shift_r(r, s, 0.0)
        a_p, b_p, c_p = shift(a, -s, 0.0), shift(b, -s, 1.0), shift(c, -s, 0.0)
        r_p = shift_r(r, -s, 0.0)
        alpha = -a / _nonzero(b_m)
        beta = -c / _nonzero(b_p)
        a = alpha * a_m
        c = beta * c_p
        b = b + alpha * c_m + beta * a_p
        r = r + alpha[..., None] * r_m + beta[..., None] * r_p
        s *= 2
    return r / _nonzero(b)[..., None]


# threshold above which the reference switches from Thomas to PCR
_PCR_MIN_LEN = 128


def tridiag_solve(dl, d, du, rhs):
    """Dispatch: sequential Thomas for short lines, PCR for long."""
    if d.shape[-1] >= _PCR_MIN_LEN:
        return tridiag_pcr(dl, d, du, rhs)
    return thomas(dl, d, du, rhs)


def numpy_gmres(A, M_inv, b, rtol, atol, restart, max_restarts):
    """Restarted right-preconditioned GMRES in pure NumPy f64 (host
    backend of SparseSystem)."""
    bnorm = float(np.linalg.norm(b))
    tol = max(rtol * bnorm, atol)
    m = restart
    x = np.zeros_like(b)
    rn = bnorm
    for _ in range(max_restarts):
        r = b - A(x)
        beta = float(np.linalg.norm(r))
        rn = beta
        if beta <= tol:
            break
        V = [r / beta]
        H = np.zeros((m + 1, m))
        k_used = m
        for k in range(m):
            w = A(M_inv(V[k]))
            for i in range(k + 1):
                hik = float(np.vdot(V[i], w))
                H[i, k] = hik
                w = w - hik * V[i]
            hk1 = float(np.linalg.norm(w))
            H[k + 1, k] = hk1
            if hk1 <= 1e-300:
                k_used = k + 1
                break
            V.append(w / hk1)
        e1 = np.zeros(m + 1)
        e1[0] = beta
        y, *_ = np.linalg.lstsq(H[: k_used + 1, :k_used], e1[: k_used + 1],
                                rcond=None)
        dx = V[0] * y[0]
        for i in range(1, k_used):
            dx = dx + y[i] * V[i]
        x = x + M_inv(dx)
    else:
        rn = float(np.linalg.norm(b - A(x)))
    if rn > tol:
        _warn_nonconverged("gmres(numpy)", max_restarts * m, rn, tol)
    return x, rn


def numpy_bicgstab(A, M_inv, b, rtol, atol, max_iters, x0=None):
    """Preconditioned BiCGStab in NumPy f64 — the reference's second
    user-facing Krylov backend (BiCGStab.zig:279-370): breakdown guards at
    1e-30, defaults max_iters=1000 / rtol 1e-6 / atol 1e-8, warning on
    non-convergence. Right-preconditioned (the reference preconditions the
    residual update, same fixed point)."""
    x = np.zeros_like(b) if x0 is None else x0.copy()
    r = b - A(x)
    bnorm = float(np.linalg.norm(b))
    tol = max(rtol * bnorm, atol)
    rn = float(np.linalg.norm(r))
    if rn <= tol:
        return x, rn
    r_hat = r.copy()
    rho_old = alpha = omega = 1.0
    v = np.zeros_like(b)
    p = np.zeros_like(b)
    it = 0
    for it in range(1, max_iters + 1):
        rho_new = float(np.vdot(r_hat, r))
        if abs(rho_new) < 1e-30:
            break  # breakdown (BiCGStab.zig rho guard)
        if it == 1:
            p = r.copy()
        else:
            beta = (rho_new / rho_old) * (alpha / omega)
            p = r + beta * (p - omega * v)
        p_hat = M_inv(p)
        v = A(p_hat)
        den = float(np.vdot(r_hat, v))
        if abs(den) < 1e-30:
            break
        alpha = rho_new / den
        s = r - alpha * v
        sn = float(np.linalg.norm(s))
        if sn <= tol:
            x = x + alpha * p_hat
            rn = sn
            break
        s_hat = M_inv(s)
        t = A(s_hat)
        tt = float(np.vdot(t, t))
        if tt < 1e-30:
            break
        omega = float(np.vdot(t, s)) / tt
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        rn = float(np.linalg.norm(r))
        if rn <= tol:
            break
        if abs(omega) < 1e-30:
            break
        rho_old = rho_new
    if rn > tol:
        _warn_nonconverged("bicgstab", it, rn, tol)  # absolute, like tol
    return x, rn
