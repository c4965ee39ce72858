"""PyTorch/CUDA port, ``roofline``: the H100's peaks, the shares and the
binding resource against the JAX package's ``roofline.classify``, the cost
models' scaling, and the bounds they give at the main path's shapes, which
are the bound column of PERF.md's kernel table."""

import inspect

import numpy as np
import pytest
import torch

import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu import roofline as jx_rl
from pyaudiodsptools_tpu_torch import roofline as rl
from pyaudiodsptools_tpu_torch.kernels import dynamics as kdyn, relayout, tail
from pyaudiodsptools_tpu_torch.ops import fft_filter

H100 = "NVIDIA H100 80GB HBM3"
# the main path: chain8, 64 channels x 30 s at 44.1 kHz, padded to blocks
C = 64
T = 1_323_008


def test_peaks_of_the_h100():
    pk = rl.peaks_for(H100)
    assert (pk.hbm_bytes_per_s, pk.tensor_tf32_flops, pk.fp32_flops) == \
        (3.35e12, 495e12, 67e12)
    for other in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "TPU v5 lite",
                  ""):
        with pytest.raises(ValueError, match="no published peaks"):
            rl.peaks_for(other)


def test_peaks_for_device_needs_a_card():
    with pytest.raises(ValueError, match="a card"):
        rl.peaks_for_device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        rl.peaks_for_device()


# the four cases of tests/test_roofline.py's classifier test, in the JAX
# package's (bytes, mxu, vpu) order
CLASSIFY_CASES = [((90.0, 5.0, 0.0), "hbm-bandwidth"),
                  ((5.0, 80.0, 0.0), "tensor-compute"),
                  ((5.0, 5.0, 50.0), "fp32-compute"),
                  ((1.0, 1.0, 1.0), "latency/overhead")]


@pytest.mark.parametrize("counts,resource", CLASSIFY_CASES)
@pytest.mark.parametrize("peaks", [(100.0, 100.0, 100.0),
                                   (3.35e12, 495e12, 67e12)])
def test_classify_agrees_with_jax(counts, resource, peaks):
    hbm, tensor, fp32 = peaks
    nbytes, mxu, vpu = counts
    scale = 1.0 if hbm == 100.0 else 1e10
    jcost = {"bytes": nbytes * scale, "mxu_flops": mxu * scale,
             "vpu_flops": vpu * scale}
    cost = {"bytes": nbytes * scale, "tensor_flops": mxu * scale,
            "fp32_flops": vpu * scale}
    want = jx_rl.classify(1.0, jcost, jx_rl.Peaks(
        mxu_bf16_flops=tensor, hbm_bytes_per_s=hbm, vpu_f32_flops=fp32))
    got = rl.classify(1.0, cost, rl.Peaks(hbm, tensor, fp32))
    assert got == {
        "model_gb": want["model_gb"],
        "model_tensor_gflop": want["model_mxu_gflop"],
        "model_fp32_gflop": want["model_vpu_gflop"],
        "hbm_roofline_pct": want["hbm_roofline_pct"],
        "tensor_roofline_pct": want["mxu_roofline_pct"],
        "fp32_roofline_pct": want["vpu_roofline_pct"],
        "bound": want["bound"].replace("mxu", "tensor").replace("vpu",
                                                                "fp32")}
    if hbm == 100.0:
        assert got["bound"] == resource


def _costs(channels):
    stages = [("taps", (6615, 13230), False, 0), ("gain", 0),
              ("map", "softclipper", 2, 1)]
    return {
        "conv": rl.conv_cost(channels, T, 32768, 23552),
        "partitioned_conv": rl.partitioned_conv_cost(
            channels, T, [(32768, 16384), (32768, 16384), (16384, 8192)]),
        "conv_pairs": rl.conv_pairs_cost(channels * 64, 16384),
        "conv_pairs_step": rl.conv_pairs_cost(channels * 64, 16384,
                                              21507, 4096),
        "audio_walk": rl.dynamics_cost(channels, T, 2, True, channels * 256),
        "state_walk": rl.dynamics_cost(channels, T, 2, False,
                                       channels * 256),
        "stage": rl.dynamics_cost(channels, T, 1),
        "serial_walk": rl.serial_walk_cost(channels, 4096, 2),
        "tail": rl.tail_cost(channels, T, stages, channels * T),
        "simple": rl.simple_cost(channels, T, 1.0, 1.0, 4.0)}


@pytest.mark.parametrize("name", sorted(_costs(1)))
def test_costs_scale_linearly_in_channels(name):
    base, dbl = _costs(64)[name], _costs(128)[name]
    for key in ("bytes", "fp32_flops"):
        assert abs(dbl[key] / base[key] - 2.0) < 0.05, key
    assert base["tensor_flops"] == dbl["tensor_flops"] == 0.0


def test_conv_cost_from_params_reads_a_fir_plan():
    cfg = pt.EngineConfig(44100, 4096)
    eff = pt.ops.lowcut(cfg, 200.0, device="cpu")
    (plan,) = eff.params.plans
    cost = rl.conv_cost_from_params(C, T, eff.params)
    assert cost == rl.conv_cost(C, T, plan.n, plan.seg)
    assert cost["fp32_flops"] > 0 and cost["bytes"] > 8 * C * T
    assert rl.conv_cost_from_params(
        C, T, pt.ops.tremolo(cfg, device="cpu").params) is None
    # a FIR in partitions: the signal once, every partition's windows
    long_fir = fft_filter.fir(np.random.default_rng(3).standard_normal(
        40_000) * 0.01, 4096, device="cpu")
    plans = long_fir.params.plans
    assert len(plans) == 3
    cost = rl.conv_cost_from_params(C, T, long_fir.params)
    assert cost["fp32_flops"] == sum(
        rl.conv_cost(C, T, q.n, q.seg)["fp32_flops"] for q in plans)
    assert cost["bytes"] == 8 * C * T + sum(16 * q.n for q in plans)
    # the effects whose offline is a FIR they carry: the reverb's combined
    # kernel, the EQ's FIR-ised response
    rev = pt.ops.reverb(cfg, device="cpu")
    assert rl.conv_cost_from_params(C, T, rev.params) == \
        rl.conv_cost_from_params(C, T, rev.params.full)
    eq = pt.ops.eq3band(cfg, 200.0, 3.5, 1000.0, -2.5, 8000.0, 4.0,
                        device="cpu")
    assert eq.params.fir is not None
    assert rl.conv_cost_from_params(C, T, eq.params) == \
        rl.conv_cost_from_params(C, T, eq.params.fir)


def test_conv_cost_does_not_depend_on_the_implementation():
    cfg = pt.EngineConfig(44100, 512)
    eff = pt.ops.highcut(cfg, 8000.0, device="cpu")
    assert "use_kernels" not in inspect.signature(
        rl.conv_cost_from_params).parameters
    before = rl.conv_cost_from_params(2, 8 * 512, eff.params)
    blocks = torch.zeros((2, 8, 512))
    for use_kernels in (True, False):
        eff.offline(eff.params, blocks, use_kernels=use_kernels)
        assert rl.conv_cost_from_params(2, 8 * 512, eff.params) == before


def _chain8(B):
    cfg = pt.EngineConfig(44100, B)
    o = pt.ops
    return pt.Chain([
        o.lowcut(cfg, 120.0, device="cpu"),
        o.highcut(cfg, 12000.0, device="cpu"),
        o.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5,
                      device="cpu"),
        o.compressor(cfg, -18.0, 0.6, 3.1, 30.1, device="cpu"),
        o.gate(cfg, -45.0, 0.1, 3.1, 200.1, device="cpu"),
        o.delay(cfg, 150.0, 2, device="cpu"),
        o.tremolo(cfg, 0.3, 5.0, device="cpu"),
        o.softclipper(cfg, 0.44, device="cpu")], device="cpu")


# PERF.md's kernel table, column "bound ms (by)": B=4096 and B=512, as
# printed there (the digits it prints)
PERF_BOUNDS = {1: ("0.202", "0.202"), 2: ("0.204", "0.204"),
               3: ("0.202", "0.202"), 4: ("0.101", "0.101"),
               5: ("0.202", "0.202"), 6: ("0.202", "0.202"),
               7: ("0.00063", "0.00008"), 8: ("0.0040", "0.0005")}


@pytest.mark.parametrize("row", sorted(PERF_BOUNDS))
def test_bounds_at_the_main_path_are_perf_md_s(row):
    pk = rl.peaks_for(H100)
    for B, printed in zip((4096, 512), PERF_BOUNDS[row]):
        chain = _chain8(B)
        fir_e, dyn_e, _ = chain.exec_effects
        n_ops = len(dyn_e.params)
        G, L, Rp = relayout.geometry(C, T, kdyn.plan_segments(C, T))
        stages = tail._plan_stages(chain.effects[5:])[0]
        cost = {
            1: lambda: rl.conv_cost_from_params(C, T, fir_e.params),
            2: lambda: rl.tail_cost(C, T, stages, T),
            3: lambda: rl.dynamics_cost(C, T, n_ops, True, C * G),
            4: lambda: rl.dynamics_cost(C, T, n_ops, False, C * G),
            5: lambda: rl.simple_cost(C, T, 1.0, L * Rp / (C * T)),
            6: lambda: rl.simple_cost(C, T, L * Rp / (C * T), 1.0),
            7: lambda: rl.serial_walk_cost(C, B, n_ops),
            8: lambda: rl.conv_pairs_cost(C, fir_e.params.stream.n,
                                          fir_e.params.history, B),
        }[row]()
        b = rl.bound(cost, pk)
        assert b["bound_by"] == "bytes"
        digits = len(printed.split(".")[1])
        assert f"{b['bound_ms']:.{digits}f}" == printed, (row, B, b)
