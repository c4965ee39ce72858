"""The frozen roofline counts what pyaudiodsptools_tpu_torch/roofline.py
counts today, at the cells' shapes."""

import pytest

from portbench import geometry, roofline, spec
from pyaudiodsptools_tpu_torch import roofline as rl
from pyaudiodsptools_tpu_torch.kernels import tail as ktail
from pyaudiodsptools_tpu_torch.ops.fft_filter import fused_kernel
from portbench import port


def test_peaks_are_the_programs():
    for name, (hbm, fp32) in roofline.PEAKS.items():
        pk = rl.peaks_for(name)
        assert (pk.hbm_bytes_per_s, pk.fp32_flops) == (hbm, fp32)


@pytest.mark.parametrize("block_size", [512, 4096])
def test_filter_geometry_and_conv_cost(block_size):
    config = spec.cell("chain8.offline_repeat").config
    chain, _ = port.chain(config, block_size, "cpu")
    fir = chain.exec_effects[0]
    C, T = 64, block_size * 323
    g = geometry.of(config, block_size, C, T)
    kernel = fused_kernel(chain.effects[:3])
    assert g["fir_taps"] == [fir.params.kernel_len]
    assert len(kernel) - g["fir_taps"][0] == fir.params.lead
    assert [(q.n, q.seg) for q in fir.params.plans] == \
        [roofline.conv_window(g["fir_taps"][0])]
    mine = roofline.conv_cost(C, T, g["fir_taps"][0])
    theirs = rl.conv_cost_from_params(C, T, fir.params)
    assert mine["bytes"] == theirs["bytes"]
    assert mine["fp32_flops"] == theirs["fp32_flops"]


@pytest.mark.parametrize("audio", [False, True])
def test_walk_cost(audio):
    C, T = 64, 4096 * 323
    mine = roofline.walk_cost(C, T, 2, audio)
    theirs = rl.dynamics_cost(C, T, 2, audio=audio, lanes=0)
    assert (mine["bytes"], mine["fp32_flops"]) == \
        (theirs["bytes"], theirs["fp32_flops"])


def test_tail_cost():
    config = spec.cell("chain8.offline_repeat").config
    chain, _ = port.chain(config, 4096, "cpu")
    C, T = 64, 4096 * 323
    g = geometry.of(config, 4096, C, T)
    stages, _, n_gain, _ = ktail._plan_stages(chain.effects[5:])
    mine = roofline.tail_cost(C, T, g["tail_stages"][0])
    theirs = rl.tail_cost(C, T, stages, n_gain * T)
    assert (mine["bytes"], mine["fp32_flops"]) == \
        (theirs["bytes"], theirs["fp32_flops"])


def test_bound_is_the_larger_of_the_two_budgets():
    c = roofline.cost(3.35e12, 67e12 / 2)
    assert roofline.bound_s(c, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
    with pytest.raises(ValueError):
        roofline.bound_s(c, "another card")
