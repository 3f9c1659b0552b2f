"""Zebra line-relaxation half-sweep: the multigrid smoother hot loop.

One call performs one colored half-sweep of zebra line relaxation on the
whole ghost-framed block stack: residual of the 9-point glued Winslow
stencil, tridiagonal line solves along ``axis``, masked colored update.
All operands are (B, Ng, Mg) f32 planes, x/y components separate.

``zebra_half_sweep`` is the wrapper: a CUDA tensor launches the
hand-written kernel ``csrc/zebra.cu`` (or raises), a CPU tensor runs the
plain version ``zebra_half_sweep_ref``. The kernel is built with nvcc at
first use by ``ops._build`` into ``build/turbomesh_tpu_torch/`` as an
extension module (no PyTorch headers). It solves
each line by a partitioned elimination over ``zebra_chunks(n)`` chunks;
``tests/test_torch_zebra.py`` emulates that arithmetic on the CPU.

Counterpart of turbomesh_tpu/ops/zebra.py (``zebra_pass``).
"""

from __future__ import annotations

import torch

from . import _build

#: kernel launches since the last reset (chip_smoke.py reads it to show
#: that the main path went through the kernel)
ZEBRA_LAUNCHES = 0

#: the kernel cuts each line into chunks of at least MIN_CHUNK points, at
#: most MAX_CHUNKS of them (a warp's lanes along axis 1, a CTA's warps
#: along axis 0)
MIN_CHUNK = 8
MAX_CHUNKS = 32

_ENTRY = None   # the loaded entry point


def load_library():
    """Build (if needed) and load the kernel library; idempotent."""
    return _build.load_library("zebra")


def zebra_chunks(n: int) -> int:
    """K, the chunks a line of ``n`` points is cut into by the kernel's
    partitioned solve: one per MIN_CHUNK points, at most MAX_CHUNKS. K = 1
    (lines of fewer than 2 * MIN_CHUNK points) is Thomas along the whole
    line. Chunk k holds the points [k n / K, (k + 1) n / K)."""
    return max(1, min(MAX_CHUNKS, n // MIN_CHUNK))


def _check_planes(planes):
    ref = planes[-1]
    shape, device = ref.shape, ref.device
    if len(shape) != 3:
        raise ValueError(f"zebra planes must be (B, Ng, Mg), got {tuple(shape)}")
    for t in planes:
        if t.dtype != torch.float32:
            raise TypeError(f"zebra planes must be float32, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"zebra plane shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError("zebra planes must be contiguous")
        if t.device != device:
            raise ValueError("zebra planes must share one device")


def zebra_half_sweep(bx, by, cfp, cfq, dl, d, du, msk, sel, rx, ry, zx, zy,
                     axis: int):
    """One colored zebra half-sweep; returns the updated (zx, zy).

    ``axis``: line direction within a plane (0 = i-lines, 1 = j-lines);
    ``msk`` = smooth mask, ``sel`` = msk x color parity; (dl, d, du) the
    line tridiagonals (identity rows decouple the chains). CPU tensors run
    the plain version; CUDA tensors launch the kernel (on PyTorch's current
    stream) or raise."""
    global ZEBRA_LAUNCHES, _ENTRY
    planes = (bx, by, cfp, cfq, dl, d, du, msk, sel, rx, ry, zx, zy)
    if axis != 0 and axis != 1:
        raise ValueError(f"axis must be 0 or 1, got {axis!r}")
    _check_planes(planes)
    if not zx.is_cuda:
        if zx.is_cpu:
            return zebra_half_sweep_ref(*planes, axis=axis)
        raise RuntimeError(f"zebra_half_sweep: unsupported device {zx.device}")
    if _ENTRY is None:
        _ENTRY = load_library().zebra_half_sweep
    B, Ng, Mg = zx.shape
    # outx, outy, then the kernel's scratch: four f64 planes
    out = torch.empty((10, B, Ng, Mg), dtype=torch.float32, device=zx.device)
    _build.launch(_ENTRY, zx.get_device(),
                  *[t.data_ptr() for t in planes], out.data_ptr(),
                  B, Ng, Mg, axis, zebra_chunks(Mg if axis else Ng))
    ZEBRA_LAUNCHES += 1
    return out[0], out[1]


# ---------------------------------------------------------------------------
# plain version (torch translation of turbomesh_tpu/ops/zebra.py _zebra_math
# with the PCR line solve of _pcr1)
# ---------------------------------------------------------------------------


def _pcr(a, b, c, r, dim: int, n: int):
    """Parallel cyclic reduction along ``dim`` with shared diagonals for
    the rhs stack ``r`` (leading axis = rhs index). Identity rows
    (a=c=0, b=1) decouple chains; out-of-range neighbours are identity."""
    steps = max(1, (max(n, 2) - 1).bit_length())
    shape = [1] * a.dim()
    shape[dim] = n
    idx = torch.arange(n, device=a.device).view(shape)

    s = 1
    for _ in range(steps):
        lo = idx >= s       # row - s is in range
        hi = idx < n - s    # row + s is in range
        abc = torch.stack([a, b, c])
        m = torch.roll(abc, s, dims=dim + 1)
        p = torch.roll(abc, -s, dims=dim + 1)
        a_m, b_m, c_m = (torch.where(lo, m[0], 0.0), torch.where(lo, m[1], 1.0),
                         torch.where(lo, m[2], 0.0))
        a_p, b_p, c_p = (torch.where(hi, p[0], 0.0), torch.where(hi, p[1], 1.0),
                         torch.where(hi, p[2], 0.0))
        r_m = torch.where(lo, torch.roll(r, s, dims=dim + 1), 0.0)
        r_p = torch.where(hi, torch.roll(r, -s, dims=dim + 1), 0.0)
        alpha = -a / torch.where(b_m == 0, 1.0, b_m)
        beta = -c / torch.where(b_p == 0, 1.0, b_p)
        a2 = alpha * a_m
        c2 = beta * c_p
        b = b + alpha * c_m + beta * a_p
        a, c = a2, c2
        r = r + alpha * r_m + beta * r_p
        s *= 2
    return r / torch.where(b == 0, 1.0, b)


def residual_ref(bx, by, cfp, cfq, msk, rx, ry, zx, zy):
    """Masked glued Winslow residual ``msk * (r - A z)`` of x and y on the
    ghost-framed planes (circular shifts only reach masked rows)."""
    up = lambda z: torch.roll(z, -1, dims=1)    # z_{i+1,j}
    dn = lambda z: torch.roll(z, 1, dims=1)     # z_{i-1,j}
    rt = lambda z: torch.roll(z, -1, dims=2)    # z_{i,j+1}
    lt = lambda z: torch.roll(z, 1, dims=2)     # z_{i,j-1}

    x_xi = 0.5 * (up(bx) - dn(bx))
    y_xi = 0.5 * (up(by) - dn(by))
    x_eta = 0.5 * (rt(bx) - lt(bx))
    y_eta = 0.5 * (rt(by) - lt(by))
    g11 = x_xi * x_xi + y_xi * y_xi
    g22 = x_eta * x_eta + y_eta * y_eta
    g12 = x_xi * x_eta + y_xi * y_eta

    diag = -2.0 * (g11 + g22)
    c_ip = g22 * (1 + 0.5 * cfp)
    c_im = g22 * (1 - 0.5 * cfp)
    c_jp = g11 * (1 + 0.5 * cfq)
    c_jm = g11 * (1 - 0.5 * cfq)
    h = 0.5 * g12

    def apply_stencil(z):
        return (
            diag * z
            + c_ip * up(z) + c_im * dn(z)
            + c_jp * rt(z) + c_jm * lt(z)
            - h * up(rt(z)) + h * up(lt(z))
            + h * dn(rt(z)) - h * dn(lt(z))
        )

    return msk * (rx - apply_stencil(zx)), msk * (ry - apply_stencil(zy))


def zebra_half_sweep_ref(bx, by, cfp, cfq, dl, d, du, msk, sel, rx, ry, zx,
                         zy, axis: int):
    """Plain PyTorch version of the half-sweep (circular shifts + PCR),
    batched over the leading block axis. Used on CPU tensors and as the
    reference the kernel is held against on the card."""
    resx, resy = residual_ref(bx, by, cfp, cfq, msk, rx, ry, zx, zy)
    n = zx.shape[1 + axis]
    sol = _pcr(dl, d, du, torch.stack([resx, resy]), 1 + axis, n)
    return zx + sel * sol[0], zy + sel * sol[1]
