"""PyTorch/CUDA port, the module that holds the segmented-conv kernel
(``kernels/segconv.py``): its plain version against the JAX package's Pallas
kernel in interpret mode and a float64 oracle; the numpy mirror of the CUDA
schedule against the plain version; and, on a card, the kernel itself."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyaudiodsptools_tpu.kernels.pallas_conv import segmented_conv_fused
from pyaudiodsptools_tpu.ops.fft_filter import pack_spectrum
from pyaudiodsptools_tpu_torch.kernels import segconv
from pyaudiodsptools_tpu_torch.ops import fft_filter as pt_fir

from torch_port_util import (conv_oracle, emulate_segconv, emulate_window_fft,
                             snr_db)


def _port_plan(k, shift, device="cpu"):
    halo, seg = pt_fir.plan_segments(len(k))
    return segconv.make_plan(k, halo, seg, shift, device)


# The cases of tests/test_fusion.py::test_segmented_conv_fused_matches_oracle,
# at its geometry (B=2048, halo 2, seg 6 -> n = 16384).
CASES = [(3, 25, 4000, 1371),   # odd segment count, big shift
         (1, 6, 1, 0),          # identity kernel, single short channel
         (2, 48, 4096, 2048)]   # kernel (almost) filling the halo


@pytest.mark.parametrize("C,nb,klen,shift", CASES)
def test_plain_conv_matches_pallas_kernel_and_oracle(C, nb, klen, shift):
    B, halo, seg = 2048, 2, 6
    n = (halo + seg) * B
    rng = np.random.default_rng(klen % 89)
    x = rng.standard_normal((C, nb * B)).astype(np.float32)
    k = rng.standard_normal(klen) * 0.1
    spec = pack_spectrum(np.fft.rfft(np.concatenate([k, np.zeros(n - klen)])))
    pallas = np.asarray(segmented_conv_fused(jnp.asarray(x), spec, B, halo,
                                             seg, shift, interpret=True))
    oracle = conv_oracle(x, k, shift)
    for plan in (_port_plan(k, shift),                       # the port's window
                 segconv.make_plan(k, halo * B, seg * B, shift, "cpu")):
        got = segconv.segmented_conv(torch.from_numpy(x), plan).numpy()
        assert got.shape == x.shape and got.dtype == np.float32
        # the Pallas kernel's default tier is a bf16x3 split at about 102 dB,
        # so the bar to the kernel is the looser of the two
        assert snr_db(pallas, got) >= 95.0
        assert snr_db(oracle, got) >= 100.0


@pytest.mark.parametrize("n,halo,klen,shift,T,blocks", [
    (16, 4, 5, 3, 100, 1),            # smallest window, log2 even
    (32, 8, 9, 0, 77, 1),             # log2 odd: the extra radix-2 pass
    (1024, 128, 100, 37, 5000, 1),
    (2048, 256, 257, 0, 7001, 1),     # odd, ragged last window, odd count
    (8192, 1024, 1017, 1155, 20000, 1),   # the B=512 flagship geometry
    (256, 32, 30, 5, 3001, 4),        # the smallest cluster windows
    (256, 64, 60, 0, 2999, 2),
    (512, 128, 100, 77, 4003, 4),     # log2 odd over a cluster
    (2048, 512, 500, 9, 9001, 2),
    (32768, 4096, 4096, 1371, 60001, 2),    # the clusters' own windows
    (65536, 8192, 8185, 9219, 130003, 4),   # the B=4096 flagship geometry
])
def test_cuda_schedule_mirror_matches_plain(n, halo, klen, shift, T, blocks):
    """csrc/segconv.cu's passes, mirrored in numpy with the plan's own
    tables: digit-reversed spectrum, twiddles, masked gather and store, and
    over a cluster of 2 or 4 blocks the top pass through the blocks' shared
    memory."""
    rng = np.random.default_rng(n + blocks)
    k = rng.standard_normal(klen) * 0.1
    plan = segconv.make_plan(k, halo, n - halo, shift, "cpu")
    x = rng.standard_normal((2, T)).astype(np.float32)
    mirror = emulate_segconv(x, plan, blocks)
    assert np.isfinite(mirror).all()       # every output sample was stored
    plain = segconv.segmented_conv_plain(torch.from_numpy(x), plan).numpy()
    assert snr_db(plain, mirror) >= 120.0
    assert snr_db(conv_oracle(x, k, shift), mirror) >= 120.0


@pytest.mark.parametrize("n", [256, 512, 2048])
@pytest.mark.parametrize("blocks", [2, 4])
def test_cluster_transform_mirror_is_bit_equal_to_one_block(n, blocks):
    """The cluster transform does the one-block transform's operations on
    the same operands in the same order: the mirrors agree bit for bit (as
    the kernels must on the card)."""
    rng = np.random.default_rng(n * blocks)
    plan = segconv.make_plan(rng.standard_normal(n // 4) * 0.1, n // 4,
                             n - n // 4, 0, "cpu")
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    one = emulate_window_fft(z, plan)
    assert np.isfinite(one).all()
    np.testing.assert_array_equal(emulate_window_fft(z, plan, blocks), one)


@pytest.mark.parametrize("n", [16, 32, 64, 128, 8192, 16384])
def test_dif_positions_is_the_transforms_output_order(n):
    pos = segconv.dif_positions(n)
    assert sorted(pos) == list(range(n))
    radices = segconv.stage_radices(n)
    assert int(np.prod(radices)) == n and set(radices) <= {2, 4}
    assert radices.count(2) <= 1 and radices[-1:] != [4] or n % 4 == 0


def test_plan_and_launch_checks():
    k = np.ones(100)
    with pytest.raises(ValueError, match="power of two"):
        segconv.make_plan(k, 100, 900, 0, "cpu")
    with pytest.raises(ValueError, match="power of two"):
        segconv.make_plan(k, 128, 2 * segconv.MAX_WINDOW - 128, 0, "cpu")
    with pytest.raises(ValueError, match="does not cover"):
        segconv.make_plan(k, 64, 960, 0, "cpu")
    with pytest.raises(ValueError, match="multiple of 4"):
        segconv.make_plan(np.ones(3), 126, 898, 0, "cpu")
    # the version follows the window: one block up to 16,384 points, a
    # cluster of two at 32,768, of four at 65,536
    assert [segconv.blocks_for(n) for n in (1024, 16384, 32768, 65536)] == \
        [1, 1, 2, 4]
    big = segconv.make_plan(k, 8192, 65536 - 8192, 0, "cpu")
    assert big.blocks == 4 and big.spectrum_dif.shape == (65536, 2)
    with pytest.raises(ValueError, match="thread blocks"):
        segconv._launch(torch.zeros(2, 64), big, blocks=1)
    plan = segconv.make_plan(k, 128, 896, 0, "cpu")
    assert plan.spectrum_dif.shape == (1024, 2)
    assert plan.twiddle is segconv.pass_twiddles(1024, torch.device("cpu"))
    # n = 1024: one two-level pass (6 rows of 64) and one single level (3 of 16)
    assert segconv.pass_schedule(1024) == [("two", 10), ("one", 6)]
    assert plan.twiddle.shape == (6 * 64 + 3 * 16, 2)
    # the launcher refuses what the kernel does not take
    with pytest.raises(ValueError, match="contiguous"):
        segconv._launch(torch.zeros(2, 64, dtype=torch.float64), plan)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    before = segconv.launch_count
    plan = segconv.make_plan(np.ones(3), 128, 896, 0, "cpu")
    y = segconv.segmented_conv(torch.ones(1, 2000), plan)
    assert segconv.launch_count == before
    np.testing.assert_allclose(y[0, 2:].numpy(), 3.0, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("C,nb,klen,shift", CASES)
def test_cuda_kernel_matches_plain_on_card(C, nb, klen, shift):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(klen % 89)
    x = torch.from_numpy(rng.standard_normal((C, nb * 2048)).astype(np.float32))
    k = rng.standard_normal(klen) * 0.1
    plan = _port_plan(k, shift, "cuda")
    before = segconv.launch_count
    got = segconv.segmented_conv(x.cuda(), plan)
    torch.cuda.synchronize()
    assert segconv.launch_count == before + 1
    plain = segconv.segmented_conv(x.cuda(), plan, use_kernels=False)
    assert snr_db(plain.cpu().numpy(), got.cpu().numpy()) >= 110.0
    assert snr_db(conv_oracle(x.numpy(), k, shift), got.cpu().numpy()) >= 95.0


@pytest.mark.cuda
@pytest.mark.parametrize("n,blocks", [(256, 2), (256, 4), (2048, 2),
                                      (2048, 4), (16384, 2), (16384, 4)])
def test_cluster_versions_bit_equal_to_one_block_on_card(n, blocks):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(n + blocks)
    halo = n // 4
    k = rng.standard_normal(halo - 3) * 0.1
    plan = segconv.make_plan(k, halo, n - halo, 7, "cuda")
    x = torch.from_numpy(rng.standard_normal((3, 5 * n + 3)).astype(
        np.float32)).cuda()
    one = segconv._launch(x, plan, blocks=1)
    cluster = segconv._launch(x, plan, blocks=blocks)
    torch.cuda.synchronize()
    assert torch.equal(one, cluster)
    plain = segconv.segmented_conv(x, plan, use_kernels=False)
    assert snr_db(plain.cpu().numpy(), cluster.cpu().numpy()) >= 110.0


@pytest.mark.cuda
@pytest.mark.parametrize("n,halo", [(32768, 4096), (65536, 8192)])
def test_cluster_windows_match_plain_on_card(n, halo):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(n)
    k = rng.standard_normal(halo - 7) * 0.05
    plan = segconv.make_plan(k, halo, n - halo, 1371, "cuda")
    assert plan.blocks == n // segconv.BLOCK_WINDOW
    x = rng.standard_normal((2, 3 * n + 5)).astype(np.float32)
    got = segconv.segmented_conv(torch.from_numpy(x).cuda(), plan)
    plain = segconv.segmented_conv(torch.from_numpy(x).cuda(), plan,
                                   use_kernels=False)
    assert snr_db(plain.cpu().numpy(), got.cpu().numpy()) >= 110.0
    assert snr_db(conv_oracle(x, k, 1371), got.cpu().numpy()) >= 95.0
