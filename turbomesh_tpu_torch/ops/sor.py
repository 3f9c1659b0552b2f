"""Red-black SOR sweeps of the frozen Winslow system on one block.

Counterpart of turbomesh_tpu/ops/sor.py (``red_black_sor``), with its
layout: base, cf and x0 are (N, M, 2) fields, interior_mask an (N, M)
bool plane (points outside it are held fixed, Dirichlet), f32 or f64.
The coefficients follow from the frozen base coordinates and cf.

``red_black_sor`` is the wrapper: a CUDA tensor launches the hand-written
kernel ``csrc/sor.cu`` or raises; a CPU tensor runs the plain version
``red_black_sor_ref``. No fallback between the two. The kernel computes
the frozen coefficients in one launch, then runs up to s colored
half-sweeps a launch on tiles held in shared memory, so a call is
``sor_launches(sweeps, s)`` = 1 + ceil(2 * sweeps / s) launches;
``sor_schedule`` picks the tile and s.
"""

from __future__ import annotations

import torch

from . import _build

#: kernel launches since the last reset
SOR_LAUNCHES = 0

_ENTRY = {torch.float32: "red_black_sor_f32",
          torch.float64: "red_black_sor_f64"}

#: shared memory a CTA may take on an H100 (227 KB)
SMEM_LIMIT = 232_448
# (tile rows ti, tile columns tj, half-sweeps a launch s, CTA rows of 32
# threads), both types: small tiles and 16 half-sweeps a launch, or large
# tiles and 8, which redo less of the halo a point but fill fewer SMs
_SMALL = (16, 32, 16, 16)
_LARGE = (32, 48, 8, 16)
# take the large tiles where a block has enough of them for this share of
# the SMs in one wave (the scale-4 block 881 x 161: 112 tiles on 132 SMs)
_LARGE_FILL = 0.75
_SMS: dict[int, int] = {}
# csrc/sor.cu: a lane holds a column pair of the grown tile, a thread at
# most this many of its rows
_ROWS_PER_THREAD = 4


def sor_schedule(N: int, M: int, sms: int = 132) -> tuple[int, int, int, int]:
    """(ti, tj, s, rows) of the kernel on an N x M block on a card of
    ``sms`` SMs: inner tiles of ti x tj points, at most s colored
    half-sweeps a launch, CTAs of 32 x rows threads. The tiles of a block
    are as even as its size allows (no larger than the block; tj even),
    so that the last row and column of tiles hold little padding."""
    tiles = -(-N // _LARGE[0]) * -(-M // _LARGE[1])
    ti, tj, s, rows = _LARGE if tiles >= _LARGE_FILL * sms else _SMALL
    ti = -(-N // -(-N // ti))
    tj = -(-M // -(-M // tj))
    return ti, tj + tj % 2, s, rows


def sor_smem_bytes(ti: int, tj: int, s: int, dtype) -> int:
    """Shared memory of a CTA (csrc/sor.cu smem_bytes): per point of the
    tile grown by s, x and y and seven coefficients; a parity byte a row
    and a column."""
    elem = torch.empty((), dtype=dtype).element_size()
    h, w = ti + 2 * s, tj + 2 * s
    return h * w * (2 + 7) * elem + h + w


def sor_schedule_fits(ti: int, tj: int, s: int, rows: int, dtype) -> bool:
    """Whether csrc/sor.cu takes the schedule: the grown tile at most 64
    columns (an even number: a lane a column pair) and _ROWS_PER_THREAD *
    rows rows, at most 512 threads, shared memory within SMEM_LIMIT."""
    return (min(ti, tj, s, rows) >= 1 and tj % 2 == 0 and tj + 2 * s <= 64
            and ti + 2 * s <= _ROWS_PER_THREAD * rows and 32 * rows <= 512
            and sor_smem_bytes(ti, tj, s, dtype) <= SMEM_LIMIT)


def sor_launches(sweeps: int, s: int) -> int:
    """Kernel launches of a call: the coefficients' and ceil(2 * sweeps /
    s) of the tiles, none for no sweeps."""
    return 1 - (-2 * int(sweeps) // s) if sweeps > 0 else 0


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
    index = x0.get_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    ti, tj, s, rows = sor_schedule(N, M, _SMS[index])
    launches = sor_launches(sweeps, s)
    base, cf, x0 = _aligned(base), _aligned(cf), _aligned(x0)
    mask = interior_mask.contiguous()
    out = torch.empty_like(x0)
    # scratch: the field the tile launches alternate with (when there are
    # two or more), then the seven coefficient planes
    tmp_values = x0.numel() if launches > 2 else 0
    scratch = torch.empty(tmp_values + 7 * N * M, dtype=x0.dtype, device=dev)
    tmp = scratch.data_ptr() if tmp_values else out.data_ptr()
    coef = scratch.data_ptr() + tmp_values * scratch.element_size()
    _build.launch(entry, index, base.data_ptr(), cf.data_ptr(),
                  mask.data_ptr(), x0.data_ptr(), coef, tmp, out.data_ptr(),
                  N, M, float(omega), int(sweeps), ti, tj, s, rows)
    SOR_LAUNCHES += launches
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
