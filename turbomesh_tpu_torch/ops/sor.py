"""Red-black SOR sweeps of the frozen Winslow system on one block.

Counterpart of turbomesh_tpu/ops/sor.py (``red_black_sor``), with its
layout: base, cf and x0 are (N, M, 2) fields, interior_mask an (N, M)
bool plane (points outside it are held fixed, Dirichlet), f32 or f64.
Coefficients are recomputed from the frozen base coordinates on the fly.

``red_black_sor`` is the wrapper: a CUDA tensor launches the hand-written
kernel ``csrc/sor.cu`` (one launch per colored half-sweep, 2 * sweeps per
call) or raises; a CPU tensor runs the plain version
``red_black_sor_ref``. No fallback between the two.
"""

from __future__ import annotations

import torch

from . import _build

#: kernel launches (colored half-sweeps) since the last reset
SOR_LAUNCHES = 0

_ENTRY = {torch.float32: "red_black_sor_f32",
          torch.float64: "red_black_sor_f64"}


def load_library():
    """Build (if needed) and load csrc/sor.cu; idempotent."""
    return _build.load_library("sor")


def _check(base, cf, x0, interior_mask):
    if x0.dim() != 3 or x0.shape[-1] != 2:
        raise ValueError(f"x0 must be (N, M, 2), got {tuple(x0.shape)}")
    if x0.dtype not in _ENTRY:
        raise TypeError(f"red_black_sor takes float32 or float64, "
                        f"got {x0.dtype}")
    for name, t in (("base", base), ("cf", cf)):
        if t.shape != x0.shape or t.dtype != x0.dtype:
            raise ValueError(f"{name} must match x0 ({tuple(x0.shape)}, "
                             f"{x0.dtype}), got {tuple(t.shape)}, {t.dtype}")
    if interior_mask.shape != x0.shape[:2] or interior_mask.dtype != torch.bool:
        raise ValueError(f"interior_mask must be a bool {tuple(x0.shape[:2])} "
                         f"plane, got {interior_mask.dtype} "
                         f"{tuple(interior_mask.shape)}")
    for t in (base, cf, interior_mask):
        if t.device != x0.device:
            raise ValueError("red_black_sor operands must share one device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on an element boundary of the (x, y) pairs."""
    t = t.contiguous()
    if t.data_ptr() % (2 * t.element_size()):
        t = t.clone()
    return t


def red_black_sor(base, cf, x0, interior_mask, omega: float = 1.5,
                  sweeps: int = 10):
    """Run ``sweeps`` red-black SOR sweeps (red half-sweep, then black) of
    the frozen Winslow system; returns the updated (N, M, 2) field. x0 is
    not modified."""
    global SOR_LAUNCHES
    _check(base, cf, x0, interior_mask)
    dev = x0.device
    if dev.type == "cpu":
        return red_black_sor_ref(base, cf, x0, interior_mask, omega, sweeps)
    if dev.type != "cuda":
        raise RuntimeError(f"red_black_sor: unsupported device {dev}")
    if sweeps <= 0:
        return x0.clone()
    entry = getattr(load_library(), _ENTRY[x0.dtype])
    N, M = x0.shape[:2]
    base, cf, x0 = _aligned(base), _aligned(cf), _aligned(x0)
    mask = interior_mask.contiguous()
    out = torch.empty_like(x0)
    tmp = torch.empty_like(x0)
    _build.launch(entry, x0.get_device(), base.data_ptr(), cf.data_ptr(),
                  mask.data_ptr(), x0.data_ptr(), tmp.data_ptr(),
                  out.data_ptr(), N, M, float(omega), int(sweeps))
    SOR_LAUNCHES += 2 * int(sweeps)
    return out


# ---------------------------------------------------------------------------
# plain version (torch translation of turbomesh_tpu/ops/sor.py _half_sweep)
# ---------------------------------------------------------------------------


def _half_sweep(bx, by, cfp, cfq, color, omega, xx, xy):
    """One colored half-sweep on (N, M) planes: circular shifts, res formed
    from the whole field before the update (Jacobi within the color)."""
    up = lambda z: torch.roll(z, -1, dims=0)    # z_{i+1,j}
    dn = lambda z: torch.roll(z, 1, dims=0)     # z_{i-1,j}
    rt = lambda z: torch.roll(z, -1, dims=1)    # z_{i,j+1}
    lt = lambda z: torch.roll(z, 1, dims=1)     # z_{i,j-1}

    x_xi_x = 0.5 * (up(bx) - dn(bx))
    x_xi_y = 0.5 * (up(by) - dn(by))
    x_eta_x = 0.5 * (rt(bx) - lt(bx))
    x_eta_y = 0.5 * (rt(by) - lt(by))
    g11 = x_xi_x * x_xi_x + x_xi_y * x_xi_y
    g22 = x_eta_x * x_eta_x + x_eta_y * x_eta_y
    g12 = x_xi_x * x_eta_x + x_xi_y * x_eta_y

    diag = -2.0 * (g11 + g22)
    c_ip = g22 * (1 + 0.5 * cfp)
    c_im = g22 * (1 - 0.5 * cfp)
    c_jp = g11 * (1 + 0.5 * cfq)
    c_jm = g11 * (1 - 0.5 * cfq)
    h = 0.5 * g12

    def res(z):
        return (
            diag * z
            + c_ip * up(z) + c_im * dn(z)
            + c_jp * rt(z) + c_jm * lt(z)
            - h * up(rt(z)) + h * up(lt(z))
            + h * dn(rt(z)) - h * dn(lt(z))
        )

    diag_safe = torch.where(diag == 0.0, 1.0, diag)
    scale = (-omega) * color / diag_safe
    return xx + scale * res(xx), xy + scale * res(xy)


def red_black_sor_ref(base, cf, x0, interior_mask, omega: float = 1.5,
                      sweeps: int = 10):
    """Plain PyTorch version of ``red_black_sor`` (the reference's
    ``use_pallas=False`` math). Used on CPU tensors and as the reference
    the kernel is held against on the card."""
    N, M = x0.shape[:2]
    dt, dev = x0.dtype, x0.device
    ii = torch.arange(N, device=dev)[:, None]
    jj = torch.arange(M, device=dev)[None, :]
    red = (((ii + jj) % 2 == 0) & interior_mask).to(dt)
    black = (((ii + jj) % 2 == 1) & interior_mask).to(dt)
    bx, by = base[..., 0], base[..., 1]
    cfp, cfq = cf[..., 0], cf[..., 1]
    xx, xy = x0[..., 0], x0[..., 1]
    for _ in range(sweeps):
        xx, xy = _half_sweep(bx, by, cfp, cfq, red, omega, xx, xy)
        xx, xy = _half_sweep(bx, by, cfp, cfq, black, omega, xx, xy)
    return torch.stack([xx, xy], dim=-1)
