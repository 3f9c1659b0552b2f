"""The interface solve's connection-chain Thomas solve (``ops/chain.py``).

On the CPU: ``chain_solve_ref`` (and the wrapper, which runs it there) is
held bit for bit to the gather + ``krylov.thomas`` + ``index_copy``
sequence that ``DeviceSmoother._stage_interface`` ran inline before the
wrapper, on the T106 plan's chain table with its real coefficients and on
random ragged tables (a chain of one point, an exact zero denominator,
rows that are all padding, chains that end in an infinite or a NaN
value); ``_stage_interface`` on a small CPU smoother is held to that inline
version of itself; the wrapper's checks raise. Both versions update the
field in place. On a card (``-m cuda``): the kernel K-I
(``csrc/chain.cu``) against the plain version on the same CUDA tensors, to
the bit (their int32 views equal), with one ``CHAIN_LAUNCHES`` a call.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from turbomesh_tpu_torch import input as torch_input
from turbomesh_tpu_torch.ops import chain
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.control_function import White
from turbomesh_tpu_torch.smoothing.device import DeviceSmoother
from turbomesh_tpu_torch.smoothing.krylov import thomas

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
T106 = ROOT / "examples" / "T106" / "T106.json"
# the repository's small O4H test mesh (1,174 points; no JAX imported here,
# so that the card's tests run where JAX is not installed)
SMALL_CELLS = {
    "o_grid": 6, "middle_i": 12, "in_up_j": 6, "in_down_j": 5, "in_i": 5,
    "out_up_j": 6, "out_down_j": 5, "out_i": 5, "down_j": 6, "bulge": 6,
    "upstream_i": 5, "downstream_i": 5,
}


def inline_chain_solve(ctx_chain, p32, vflat, zf):
    """The chain solve as ``_stage_interface`` ran it inline."""
    zero = torch.zeros((), dtype=vflat.dtype, device=vflat.device)
    one = torch.ones((), dtype=vflat.dtype, device=vflat.device)
    c_row = p32["c_row"]
    if c_row.shape[0]:
        ch_l, ch_d, ch_u = ctx_chain
        c_seg, vmask = p32["c_seg"], p32["c_seg_valid"]
        seg_dl = torch.where(vmask, ch_l[c_seg], zero)
        seg_d = torch.where(vmask, ch_d[c_seg], one)
        seg_du = torch.where(vmask, ch_u[c_seg], zero)
        rhs = torch.where(vmask[..., None], vflat[c_row[c_seg]], zero)
        sol = thomas(seg_dl, seg_d, seg_du, rhs)
        pos = p32["c_seg_pos"]
        rows = c_row[c_seg.reshape(-1)[pos]]
        cur = zf[rows]
        upd = sol.reshape(-1, 2)[pos] - cur
        zf = zf.index_copy(0, rows, cur + upd)
    return zf


def inline_stage_interface(sm, ctx, vflat):
    """``DeviceSmoother._stage_interface`` as it stood before the wrapper."""
    p32 = sm._p32
    B, N, M = sm._shape
    diag_field = ctx["diag"]
    zero = torch.zeros((), dtype=vflat.dtype, device=vflat.device)
    one = torch.ones((), dtype=vflat.dtype, device=vflat.device)
    v = vflat.reshape(B, N, M, 2)
    interior = p32["interior_mask"][..., None]
    inv_diag = 1.0 / torch.where(diag_field == 0.0, one, diag_field)
    z = torch.where(interior, zero, v * inv_diag)
    z = torch.where(p32["free_mask"], z, zero)
    zf = inline_chain_solve(ctx["chain"], p32, vflat, z.reshape(-1, 2))
    s_row = p32["s_row"]
    if s_row.shape[0]:
        s_nb = p32["s_nb"]
        for _ in range(2):
            zy = vflat[s_row, 1] + zf[s_nb, 1]
            zf = zf.index_copy(
                0, s_row, torch.stack([zf[s_row, 0], zy], dim=-1))
        zf = torch.where(p32["free_mask"].reshape(-1, 2), zf, zero)
    return zf


def _smoother_ctx(cfg, base_dir):
    inp = torch_input.load(cfg, base_dir=base_dir)
    mesh = inp.template.run(inp.geometry)
    sm = DeviceSmoother(mesh, classify(mesh), device="cpu")
    cf = White(ds_target=1e-4).init(mesh)
    X, C = sm._upload(mesh.flat_coords(), cf)
    base, _ = sm._stage_base(X, C)
    return sm, sm._stage_prepare32(base, C)


@pytest.fixture(scope="module")
def t106():
    return _smoother_ctx(str(T106), str(T106.parent))


@pytest.fixture(scope="module")
def small():
    cfg = json.loads(T106.read_text())
    cfg["template"]["O4H"]["num_cells"] = dict(SMALL_CELLS)
    return _smoother_ctx(cfg, str(ROOT))


def _args(ctx_chain, p32, vflat, zf):
    """The wrapper's arguments, with a copy of ``zf`` (updated in place)."""
    return (ctx_chain, p32["c_seg"], p32["c_seg_valid"], p32["c_seg_pos"],
            p32["c_row"], vflat, zf.clone())


def ragged_table(seed, lens, P=4000, empty_rows=0, zero_pivot=False,
                 not_finite=False, device="cpu"):
    """A random chain table in the plan's layout: chains of ``lens``
    points over distinct rows of a (P, 2) field, their entries scattered
    over the coefficient arrays, ``empty_rows`` rows of padding only (as a
    rank's table in the sharded plan), diagonally dominant f32
    coefficients; ``zero_pivot`` makes the first point of the second chain
    an exact zero denominator; ``not_finite`` makes the last point of the
    first three chains end in an infinite cp, an infinite x dp and a NaN
    diagonal. Returns (chain, p32, vflat, zf)."""
    rng = np.random.default_rng(seed)
    C = sum(lens)
    S, L = len(lens) + empty_rows, max(lens)
    order = rng.permutation(C)
    c_seg = np.zeros((S, L), dtype=np.int64)
    valid = np.zeros((S, L), dtype=bool)
    off = 0
    for s, ln in enumerate(lens):
        c_seg[s, :ln] = order[off:off + ln]
        valid[s, :ln] = True
        off += ln
    c_row = rng.choice(P, size=C, replace=False).astype(np.int64)
    dl = rng.uniform(-1.0, 1.0, C)
    du = rng.uniform(-1.0, 1.0, C)
    d = -(np.abs(dl) + np.abs(du) + rng.uniform(0.5, 1.5, C))
    if zero_pivot:
        j = c_seg[1, 0]
        d[j] = dl[j] = 0.0
    vflat = rng.standard_normal((P, 2))
    if not_finite:
        ends = [c_seg[s, ln - 1] for s, ln in enumerate(lens[:3])]
        d[ends[0]], du[ends[0]] = 1e-3, 3e38
        d[ends[1]], vflat[c_row[ends[1]], 0] = 1e-30, 3e38
        d[ends[2]] = np.nan
        dl[ends] = 0.0
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    i64 = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    p32 = {"c_seg": i64(c_seg),
           "c_seg_valid": torch.as_tensor(valid, device=device),
           "c_seg_pos": i64(np.flatnonzero(valid)), "c_row": i64(c_row)}
    zf = f32(rng.standard_normal((P, 2)))
    return (f32(dl), f32(d), f32(du)), p32, f32(vflat), zf


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


RAGGED = {
    "mixed": dict(seed=1, lens=[39, 1, 9, 149, 17, 2]),
    "zero_pivot": dict(seed=2, lens=[5, 7, 1, 30], zero_pivot=True),
    "padded_rows": dict(seed=3, lens=[12, 4], empty_rows=3),
    "single_points": dict(seed=4, lens=[1, 1, 1]),
    "one_long": dict(seed=5, lens=[600, 3]),
    "not_finite": dict(seed=13, lens=[5, 7, 9, 30], not_finite=True),
}


@pytest.mark.parametrize("case", sorted(RAGGED))
def test_ref_and_wrapper_equal_inline_on_random_tables(case):
    ch, p32, vflat, zf = ragged_table(**RAGGED[case])
    want = inline_chain_solve(ch, p32, vflat, zf)
    ref_args, args = _args(ch, p32, vflat, zf), _args(ch, p32, vflat, zf)
    ref = chain.chain_solve_ref(*ref_args)
    got = chain.chain_solve(*args)
    assert same_bits(ref, want) and same_bits(got, want)
    # in place: the field passed in is the field returned
    assert ref is ref_args[-1] and got is args[-1]
    assert torch.isfinite(want).all() != (case == "not_finite")
    # every chain row moved, every other row kept
    rows = p32["c_row"]
    keep = torch.ones(zf.shape[0], dtype=torch.bool)
    keep[rows] = False
    assert same_bits(got[keep], zf[keep])
    assert not same_bits(got[rows], zf[rows])


def test_zero_pivot_is_replaced_by_one():
    """A chain of one point whose denominator is an exact zero solves as
    x = rhs (the denominator becomes 1), as ``krylov._nonzero`` does."""
    ch, p32, vflat, zf = ragged_table(seed=6, lens=[3, 1], zero_pivot=True)
    got = chain.chain_solve(*_args(ch, p32, vflat, zf))
    row = p32["c_row"][p32["c_seg"][1, 0]]
    assert torch.equal(got[row], zf[row] + (vflat[row] - zf[row]))


def test_ref_and_wrapper_equal_inline_on_t106(t106):
    sm, ctx = t106
    p32 = sm._p32
    assert tuple(p32["c_seg"].shape) == (21, 149)
    assert int(p32["c_seg_valid"].sum()) == 809
    rng = np.random.default_rng(7)
    vflat = torch.as_tensor(rng.standard_normal((sm._p32["free_mask"].numel()
                                                  // 2, 2)),
                            dtype=torch.float32)
    zf = torch.as_tensor(rng.standard_normal(tuple(vflat.shape)),
                         dtype=torch.float32)
    want = inline_chain_solve(ctx["chain"], p32, vflat, zf)
    assert torch.equal(chain.chain_solve_ref(*_args(ctx["chain"], p32, vflat,
                                                   zf)), want)
    assert torch.equal(chain.chain_solve(*_args(ctx["chain"], p32, vflat,
                                               zf)), want)


def test_stage_interface_unchanged_and_no_launch_on_cpu(small):
    sm, ctx = small
    assert sm._p32["c_row"].shape[0] > 0 and sm._p32["s_row"].shape[0] > 0
    rng = np.random.default_rng(8)
    P = sm._p32["free_mask"].numel() // 2
    before = chain.CHAIN_LAUNCHES
    for _ in range(2):
        vflat = torch.as_tensor(rng.standard_normal((P, 2)),
                                dtype=torch.float32)
        assert torch.equal(sm._stage_interface(ctx, vflat),
                           inline_stage_interface(sm, ctx, vflat))
    assert chain.CHAIN_LAUNCHES == before


def _bad(kind):
    ch, p32, vflat, zf = ragged_table(seed=9, lens=[4, 6], P=50)
    args = list(_args(ch, p32, vflat, zf))
    if kind == "f64 coefficients":
        args[0] = tuple(t.double() for t in ch)
    elif kind == "f64 field":
        args[5] = vflat.double()
    elif kind == "int32 table":
        args[1] = p32["c_seg"].int()
    elif kind == "non-contiguous field":
        args[5] = vflat.t().contiguous().t()
    elif kind == "non-contiguous table":
        args[1] = p32["c_seg"].t().contiguous().t()
        args[2] = p32["c_seg_valid"].t().contiguous().t()
    elif kind == "table shapes":
        args[2] = p32["c_seg_valid"][:, :-1].contiguous()
    elif kind == "coefficient length":
        args[0] = (ch[0][:-1].contiguous(), ch[1], ch[2])
    elif kind == "field shapes":
        args[5] = vflat[:-1].contiguous()
    elif kind == "field width":
        args[5] = torch.zeros(50, 3)
        args[6] = torch.zeros(50, 3)
    return args


@pytest.mark.parametrize("kind, error", [
    ("f64 coefficients", TypeError), ("f64 field", TypeError),
    ("int32 table", TypeError), ("non-contiguous field", ValueError),
    ("non-contiguous table", ValueError), ("table shapes", ValueError),
    ("coefficient length", ValueError), ("field shapes", ValueError),
    ("field width", ValueError)])
def test_wrapper_raises(kind, error):
    with pytest.raises(error, match="chain_solve"):
        chain.chain_solve(*_bad(kind))


def _on_card(ch, p32, vflat, zf):
    cuda = lambda t: t.to("cuda")
    return ((tuple(cuda(t) for t in ch), {k: cuda(v) for k, v in p32.items()},
             cuda(vflat), cuda(zf)))


def _kernel_equals_plain(ch, p32, vflat, zf):
    card = _on_card(ch, p32, vflat, zf)
    args, ref_args = _args(*card), _args(*card)
    before = chain.CHAIN_LAUNCHES
    got = chain.chain_solve(*args)
    assert chain.CHAIN_LAUNCHES == before + 1
    want = chain.chain_solve_ref(*ref_args)
    torch.cuda.synchronize()
    assert got is args[-1]               # the kernel writes in place
    assert same_bits(got, want)
    assert not same_bits(got, card[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RAGGED) + ["long_shared"])
def test_kernel_equals_plain_on_random_tables(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    # 3,000 points a row: 60 KB of shared memory, past the 48 KB default
    kw = RAGGED.get(case, dict(seed=10, lens=[3000, 40], P=8000))
    _kernel_equals_plain(*ragged_table(**kw))


@pytest.mark.cuda
def test_kernel_equals_plain_on_t106(t106):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    sm, ctx = t106
    rng = np.random.default_rng(11)
    P = sm._p32["free_mask"].numel() // 2
    vflat = torch.as_tensor(rng.standard_normal((P, 2)), dtype=torch.float32)
    zf = torch.as_tensor(rng.standard_normal((P, 2)), dtype=torch.float32)
    _kernel_equals_plain(ctx["chain"], sm._p32, vflat, zf)


@pytest.mark.cuda
def test_kernel_refuses_a_table_past_shared_memory():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    # 2**15 points a row: 640 KB of shared memory, past any card's limit
    # a block (227 KB on an H100); the entry point returns
    # cudaErrorInvalidValue (1) and launches nothing
    n = 1 << 15
    ch, p32, vflat, zf = ragged_table(seed=12, lens=[n], P=2 * n,
                                      device="cuda")
    args = _args(ch, p32, vflat, zf)
    before = chain.CHAIN_LAUNCHES
    with pytest.raises(RuntimeError, match="cudaError 1$"):
        chain.chain_solve(*args)
    assert chain.CHAIN_LAUNCHES == before
    assert same_bits(args[-1], zf)
