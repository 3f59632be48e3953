"""The trace reader on a hand-made event list: host ranges mirrored on
the device are no device time, busy time is a union, idle gaps are named
by what the host was doing."""

import types

import pytest
import torch

from portbench import trace

CPU, GPU = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, dur, tid=1, annotation=False):
        self._a = (name, dev, start, dur, tid, annotation)

    def name(self):
        return self._a[0]

    def device_type(self):
        return self._a[1]

    def start_ns(self):
        return self._a[2]

    def duration_ns(self):
        return self._a[3]

    def start_thread_id(self):
        return self._a[4]

    def is_user_annotation(self):
        return self._a[5]


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_busy_time_is_the_union_of_device_activity_inside_the_window():
    evs = [Ev(trace.WINDOW, CPU, 1000, 10_000, annotation=True),
           Ev("portbench.request", CPU, 1100, 8400, annotation=True),
           Ev("aten::mm", CPU, 1200, 300),
           Ev("cudaLaunchKernel", CPU, 1300, 100),
           Ev("portbench.request", GPU, 1100, 9000, annotation=True),
           Ev("void (anonymous namespace)::k1_tiles<double, false>(double const*, int)",
              GPU, 2000, 4000),
           Ev("k1_reduce<double>(int)", GPU, 5000, 2000),  # overlaps the first
           Ev("Memcpy DtoH (Device -> Pageable)", GPU, 8000, 1000),
           Ev("early", GPU, 0, 500),  # before the window
           Ev("aten::copy_", CPU, 7500, 1600, tid=2)]  # another thread
    t = trace.read(_prof(evs))
    assert t.window_s == pytest.approx(10e-6)
    assert t.busy_s == pytest.approx(6e-6)  # [2000, 7000) and [8000, 9000)
    assert t.kernels == 2 and t.kernel_s == pytest.approx(6e-6)
    assert [n for n, _ in t.device_ops] == ["k1_tiles<double, false>", "k1_reduce<double>",
                                           "Memcpy DtoH"]
    gaps = dict(t.idle_gaps)
    assert gaps["portbench.request: aten::mm"] == pytest.approx(1e-6)  # [1000, 2000)
    assert gaps["portbench.request: python"] == pytest.approx(1e-6)  # [7000, 8000)
    assert gaps["host: python"] == pytest.approx(2e-6)  # [9000, 11000), after the request


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError, match="portbench.window"):
        trace.read(_prof([Ev("k", GPU, 0, 1)]))


def test_short_names():
    assert trace.short("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)") == \
        "at::native::reduce_kernel<512, 1>"
    assert trace.short("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
