"""K-A's share of its memory roofline over the traced iterations, in %.

Numerator: the least time the half-sweeps need, ``roofline.vcycle_bytes``
of the mesh (logical points of every level, 15 four-byte planes a
half-sweep) times the V-cycles the stretch ran, over the card's HBM
bandwidth (``peaks.json``). The V-cycles are the counter's launches over
the half-sweeps a V-cycle needs. Denominator: the device time of the K-A
kernels in the profiler's trace of the same stretch."""

from .. import roofline

#: names of the K-A kernels (turbomesh_tpu_torch/csrc/zebra.cu)
KERNELS = ("zebra_thomas_kernel", "zebra_partitioned_kernel")


def read(run):
    t = run.trace
    done = run.finished()
    bw = roofline.peak(run.device_kind, "hbm_bytes_per_s")
    if t is None or not done or bw is None:
        return None
    kernel_s = sum(s for name, s in t.device_ops.items()
                   if any(k in name for k in KERNELS))
    if kernel_s <= 0.0:
        return None
    per_cycle, cycle_bytes = roofline.vcycle_bytes(done[0].block_sizes)
    cycles = t.launches["zebra"] / per_cycle
    return 100.0 * cycles * cycle_bytes / bw / kernel_s
