"""The metric readers' arithmetic on synthetic timings and a synthetic
trace."""

import pytest
import torch

from portbench import roofline, spec, trace
from portbench.record import Run

H100 = "NVIDIA H100 80GB HBM3"


def read(name, rec):
    return spec.reader(name)(rec)


def test_render_rate_is_samples_over_the_window():
    rec = Run("c", "offline", samples=3_000_000, window_s=2.0)
    assert read("render_samples_per_s", rec) == 1.5e6
    assert read("render_samples_per_s", Run("c", "stream")) is None


def test_step_ms_is_the_window_over_its_steps_and_p99_its_tail():
    ms = [1.0] * 99 + [11.0]
    rec = Run("c", "stream", window_s=0.2, units=100, host_ms=ms)
    assert read("step_ms", rec) == pytest.approx(2.0)
    assert read("step_p99_ms", rec) == pytest.approx(1.0 + 10.0 * 0.01)
    assert read("step_ms", Run("c", "offline", units=3)) is None
    # a traced run's traced steps are left out of the tail
    traced = Run("c", "stream", host_ms=[50.0] * 5 + ms, traced_units=5)
    assert read("step_p99_ms", traced) == pytest.approx(1.0 + 10.0 * 0.01)
    assert read("step_p99_ms", Run("c", "stream", host_ms=[50.0],
                                   traced_units=1)) is None


def test_peak_setup_and_means():
    rec = Run("c", "offline", peak_reserved=3 * 2 ** 20, setup_s=4.5,
              call_ms=[1.0, 3.0], device_ms=[2.0, 4.0], walks=[2, 4],
              geometry={"dynamics_ops": [2]})
    assert read("peak_mem_mib", rec) == 3.0
    assert read("setup_s", rec) == 4.5
    assert read("entry.render_call_ms.offline", rec) == 2.0
    assert read("graph.job_device_ms.offline", rec) == 3.0
    assert read("dynamics.walks_per_job", rec) == 3.0
    assert read("peak_mem_mib", Run("c", "offline")) is None


ON_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")


class Ev:
    """A profiler event: the methods trace.summarise calls."""

    def __init__(self, kind, name, start, end):
        self.kind, self._name, self.start, self.end = kind, name, start, end

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self.kind in ON_DEVICE
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self.kind.endswith("user_annotation")

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end


def synthetic():
    return [
        Ev("user_annotation", trace.WINDOW_SPAN, 0, 1000),
        Ev("gpu_user_annotation", trace.WINDOW_SPAN, 100, 200),
        Ev("kernel", "void (anonymous namespace)::segconv_kernel<2, false>"
           "(float const*)", 100, 400),
        Ev("kernel", "void (anonymous namespace)::walk_kernel<2, true, "
           "true>(float const*)", 300, 500),
        Ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 700, 800),
        Ev("kernel", "tail_kernel", 950, 1100),     # clipped at the window
        Ev("cuda_runtime", "cudaDeviceSynchronize", 480, 720),
        Ev("cpu_op", "aten::copy_", 10, 90),
    ]


def test_kind_of_reads_the_device_and_the_name():
    kinds = [trace.kind_of(e) for e in synthetic()]
    want = [e.kind if e.kind != "cuda_runtime" else "cpu_op"
            for e in synthetic()]
    assert kinds == want


def test_summarise_unions_the_device_and_labels_the_gaps():
    s = trace.summarise(synthetic())
    assert s["window_s"] == pytest.approx(1000e-9)
    # busy: [100, 500] + [700, 800] + [950, 1000]
    assert s["busy_s"] == pytest.approx(550e-9)
    assert s["idle_pct"] == pytest.approx(45.0)
    assert s["device_events"] == 4
    assert s["by_name"]["segconv_kernel"] == [1, pytest.approx(300e-9)]
    assert s["by_name"]["tail_kernel"] == [1, pytest.approx(50e-9)]
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(100e-9)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(200e-9)
    assert gaps["python"] == pytest.approx(150e-9)
    assert s["breakdown"]["device_ops"][0][0] == "segconv_kernel"


def test_idle_share_readers_and_events_per_step():
    s = trace.summarise(synthetic())
    off = Run("c", "offline", profile=s)
    st = Run("c", "stream", profile=s, traced_units=2)
    assert read("device.idle_pct.offline", off) == pytest.approx(45.0)
    assert read("device.idle_pct.stream", off) is None
    assert read("device.idle_pct.stream", st) == pytest.approx(45.0)
    assert read("device.events_per_step.stream", st) == 2.0


def test_roofline_readers_divide_the_frozen_bound_by_kernel_time():
    C, T = 64, 4096 * 323
    prof = {"by_name": {"segconv_kernel": [2, 0.004],
                        "tail_kernel": [2, 0.002],
                        "walk_kernel": [5, 0.003]}}
    g = {"C": C, "T": T, "fir_taps": [8185], "dynamics_ops": [2],
         "tail_stages": [[("taps", 2), ("gain",), ("map", "softclipper")]]}
    rec = Run("c", "offline", device_name=H100, profile=prof,
              geometry=g, traced_units=2)
    conv = roofline.bound_s(roofline.conv_cost(C, T, 8185), H100)
    assert read("kernel.segconv.roofline_pct", rec) == pytest.approx(
        100 * 2 * conv / 0.004)
    tail = roofline.bound_s(roofline.tail_cost(C, T, g["tail_stages"][0]),
                            H100)
    assert read("kernel.tail.roofline_pct", rec) == pytest.approx(
        100 * 2 * tail / 0.002)
    state = roofline.bound_s(roofline.walk_cost(C, T, 2, False), H100)
    audio = roofline.bound_s(roofline.walk_cost(C, T, 2, True), H100)
    assert read("kernel.walks.roofline_pct", rec) == pytest.approx(
        100 * (2 * state + 3 * audio) / 0.003)
    # a kernel the trace does not hold, or two runs it cannot tell apart
    assert read("kernel.segconv.roofline_pct",
                Run("c", "offline", device_name=H100,
                    profile={"by_name": {}}, geometry=g)) is None
    g2 = dict(g, fir_taps=[100, 200])
    assert read("kernel.segconv.roofline_pct",
                Run("c", "offline", device_name=H100, profile=prof,
                    geometry=g2)) is None


def test_sharded_readers_take_the_ranks():
    ranks = [{"device_ms_mean": 10.0, "profile": {"idle_pct": 3.0}},
             {"device_ms_mean": 11.0, "profile": {"idle_pct": 7.0}}]
    rec = Run("c", "sharded", ranks=ranks)
    assert read("parallel.rank_skew_pct.sharded", rec) == pytest.approx(10.0)
    assert read("device.idle_pct.sharded", rec) == 7.0
    assert read("device.idle_pct.sharded", Run("c", "offline")) is None
