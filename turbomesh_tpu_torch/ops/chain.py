"""Connection-chain tridiagonal solve of the interface preconditioner.

One call solves every connection chain of the plan's segment table
(``c_seg``, ``c_seg_valid``: one row per chain, the valid entries index
the connection rows ``c_row``) by Thomas elimination with the chain
coefficients ``(ch_l, ch_d, ch_u)`` and the right-hand side ``vflat`` at
the chains' rows, and replaces those rows of the correction field ``zf``,
in place, by ``cur + (sol - cur)``, ``cur`` being ``zf``'s value there.

``chain_solve`` is the wrapper: a CUDA tensor launches the hand-written
kernel ``csrc/chain.cu`` (K-I; or raises), a CPU tensor runs the plain
version ``chain_solve_ref`` (gathers, ``krylov.thomas``, scatter). The
kernel returns the plain version's values bit for bit.

Counterpart of the ``lax.scan`` Thomas (turbomesh_tpu/smoothing/krylov.py
``thomas``) as turbomesh_tpu/smoothing/device.py's interface solve uses it.
"""

from __future__ import annotations

import torch

from . import _build

#: kernel launches since the last reset (chip_smoke.py and the tests read
#: it to show that the main path went through the kernel)
CHAIN_LAUNCHES = 0

_ENTRY = None   # the loaded entry point


def load_library():
    """Build (if needed) and load the kernel library; idempotent."""
    return _build.load_library("chain")


def _check(chain, c_seg, c_seg_valid, c_seg_pos, c_row, vflat, zf):
    tensors = (*chain, c_seg, c_seg_valid, c_seg_pos, c_row, vflat, zf)
    dtypes = (torch.float32,) * 3 + (torch.int64, torch.bool, torch.int64,
                                     torch.int64, torch.float32,
                                     torch.float32)
    for t, dt in zip(tensors, dtypes):
        if t.dtype != dt:
            raise TypeError(f"chain_solve: {dt} expected, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("chain_solve: inputs must be contiguous")
        if t.device != zf.device:
            raise ValueError("chain_solve: inputs must share one device")
    C = c_row.shape
    if len(C) != 1 or any(t.shape != C for t in chain):
        raise ValueError(f"chain_solve: coefficients "
                         f"{[tuple(t.shape) for t in chain]} and c_row "
                         f"{tuple(C)} must be (C,)")
    if c_seg.dim() != 2 or c_seg_valid.shape != c_seg.shape:
        raise ValueError(f"chain_solve: c_seg {tuple(c_seg.shape)} and "
                         f"c_seg_valid {tuple(c_seg_valid.shape)} must be "
                         f"one (S, L) table")
    if c_seg_pos.dim() != 1:
        raise ValueError("chain_solve: c_seg_pos must be 1-D")
    if zf.dim() != 2 or zf.shape[1] != 2 or vflat.shape != zf.shape:
        raise ValueError(f"chain_solve: vflat {tuple(vflat.shape)} and zf "
                         f"{tuple(zf.shape)} must both be (P, 2)")


def chain_solve(chain, c_seg, c_seg_valid, c_seg_pos, c_row, vflat, zf):
    """Replace every chain's connection rows of ``zf`` by the chain solve
    of ``vflat``, in place, and return ``zf`` (untouched where the plan has
    no chains, ``c_row`` empty).

    ``chain``: the (C,) f32 sub, main and super diagonals; ``c_seg``,
    ``c_seg_valid``: the (S, L) segment table; ``c_seg_pos``: the flat
    positions of its valid entries (the plain version's scatter);
    ``c_row``: (C,) flat point index of each connection row; ``vflat``,
    ``zf``: (P, 2) f32. CPU tensors run the plain version; CUDA tensors
    launch the kernel (on PyTorch's current stream) or raise, also where a
    table row needs more shared memory (five f32 values a point) than the
    device gives a block (cudaError 1, cudaErrorInvalidValue)."""
    global CHAIN_LAUNCHES, _ENTRY
    _check(chain, c_seg, c_seg_valid, c_seg_pos, c_row, vflat, zf)
    if not c_row.shape[0]:
        return zf
    if not zf.is_cuda:
        if zf.is_cpu:
            return chain_solve_ref(chain, c_seg, c_seg_valid, c_seg_pos,
                                   c_row, vflat, zf)
        raise RuntimeError(f"chain_solve: unsupported device {zf.device}")
    if _ENTRY is None:
        _ENTRY = load_library().chain_solve
    ch_l, ch_d, ch_u = chain
    _build.launch(_ENTRY, zf.get_device(), ch_l.data_ptr(), ch_d.data_ptr(),
                  ch_u.data_ptr(), c_seg.data_ptr(), c_seg_valid.data_ptr(),
                  c_row.data_ptr(), vflat.data_ptr(), zf.data_ptr(),
                  *c_seg.shape)
    CHAIN_LAUNCHES += 1
    return zf


def chain_solve_ref(chain, c_seg, c_seg_valid, c_seg_pos, c_row, vflat, zf):
    """Plain PyTorch version of ``chain_solve``: gather the chains into the
    padded (S, L) table (identity rows where it is padded), solve them by
    ``krylov.thomas``, scatter the valid entries into ``zf`` in place and
    return it. Used on CPU tensors and as the reference the kernel is held
    against on the card."""
    from ..smoothing.krylov import thomas

    zero = torch.zeros((), dtype=vflat.dtype, device=vflat.device)
    one = torch.ones((), dtype=vflat.dtype, device=vflat.device)
    ch_l, ch_d, ch_u = chain
    vmask = c_seg_valid
    seg_dl = torch.where(vmask, ch_l[c_seg], zero)
    seg_d = torch.where(vmask, ch_d[c_seg], one)
    seg_du = torch.where(vmask, ch_u[c_seg], zero)
    rhs = torch.where(vmask[..., None], vflat[c_row[c_seg]], zero)
    sol = thomas(seg_dl, seg_d, seg_du, rhs)
    # the valid chain entries are the connection rows, each once
    pos = c_seg_pos
    rows = c_row[c_seg.reshape(-1)[pos]]
    cur = zf[rows]
    upd = sol.reshape(-1, 2)[pos] - cur
    return zf.index_copy_(0, rows, cur + upd)
