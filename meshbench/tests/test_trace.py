"""The reduction of a profiled stretch: busy union, idle gaps by host op."""

import pytest

from meshbench.trace import NO_OP, Event, innermost_at, merge, summarize


def test_merge():
    assert merge([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]


def test_innermost():
    ops = [Event("outer", False, 0, 100, 1), Event("mid", False, 10, 50, 1),
           Event("inner", False, 20, 30, 1), Event("next", False, 60, 70, 1)]
    assert innermost_at(ops, [25, 5, 40, 65, 80, 200]) == [
        "inner", "outer", "mid", "next", "outer", NO_OP]


def test_summarize():
    ev = [Event("k1", True, 10, 20, 0), Event("k2", True, 15, 30, 0),
          Event("k1", True, 50, 60, 0),
          Event("outer", False, 0, 100, 7), Event("aten::add", False, 30, 45, 7),
          Event("cudaLaunchKernel", False, 40, 44, 7, runtime=True),
          Event("other_thread", False, 0, 100, 9)]
    s = summarize(ev, {"zebra": 3}, 2)
    assert s.window_s == pytest.approx(100e-9)
    assert s.busy_s == pytest.approx(30e-9)
    assert s.device_ops == pytest.approx({"k1": 20e-9, "k2": 15e-9})
    # gaps [0, 10] and [60, 100] under "outer", [30, 50] under aten::add
    # (the runtime call inside it is not an operation)
    assert s.idle_gaps == pytest.approx({"outer": 50e-9, "aten::add": 20e-9})
    assert s.top(s.device_ops, 1) == [["k1", pytest.approx(20e-9)]]
    assert s.launches == {"zebra": 3} and s.iterations == 2


def test_no_events_raises():
    with pytest.raises(RuntimeError):
        summarize([], {}, 1)


def test_label():
    from meshbench.trace import label

    mul = ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
           "impl_nocast<at::native::BinaryFunctor<float, float, float, at::"
           "native::binary_internal::MulFunctor<float> > >(at::TensorIterator"
           "Base&, at::native::BinaryFunctor<float> const&)::{lambda(int)#1}>"
           "(int, at::native::BinaryFunctor<float>)")
    assert label(mul) == "elementwise_kernel[MulFunctor]"
    assert label("void (anonymous namespace)::zebra_partitioned_kernel<0>("
                 "(anonymous namespace)::Planes, float*)") == \
        "zebra_partitioned_kernel<0>"
