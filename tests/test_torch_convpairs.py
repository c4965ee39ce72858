"""PyTorch/CUDA port, the streaming windows' convolution
(``kernels/convpairs.py``): its plain version against the JAX package's
``conv_pairs_fused`` in interpret mode and against a float64 oracle, a numpy
mirror of the CUDA schedule against the plain version, the step entry point
(window gathered from history and block, the kept samples, the next history)
against the join / convolve / slice it replaces, and what the wrappers
refuse. The CUDA kernel itself runs only on a card (``cuda`` marker)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyaudiodsptools_tpu.kernels import pallas_conv as jx_conv
from pyaudiodsptools_tpu.ops.fft_filter import pack_spectrum
from pyaudiodsptools_tpu_torch.kernels import convpairs, segconv

from torch_port_util import (emulate_convpairs, emulate_convpairs_step,
                             snr_db)

CPU = "cpu"


def _oracle(flat: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """float64 circular convolution of every row."""
    n = flat.shape[1]
    return np.fft.irfft(np.fft.rfft(flat.astype(np.float64), axis=-1)
                        * np.fft.rfft(kernel, n), n, axis=-1)


def test_plain_matches_jax_conv_pairs_fused_and_oracle():
    """(5, 16384): an odd row count at the largest window, the TPU kernel's
    smallest. The plain version is held to float64 at >= 125 dB (95 dB is the
    JAX package's bar for its conv kernel). The JAX kernel in interpret mode
    (matmul DFTs on split operands) itself sits 103 dB from float64, so that
    is what separates the two sides: the bar between them is 100 dB, and the
    port must be the one closer to float64."""
    n = 16384
    rng = np.random.default_rng(0)
    flat = rng.standard_normal((5, n)).astype(np.float32)
    kernel = rng.standard_normal(8185) * 0.05
    plan = convpairs.make_plan(kernel, n, CPU)
    assert (plan.n, plan.kernel_len) == (n, 8185)
    got = convpairs.conv_pairs(torch.from_numpy(flat), plan)
    assert got.shape == (5, n) and got.dtype == torch.float32
    packed = pack_spectrum(np.fft.rfft(np.concatenate(
        [kernel, np.zeros(n - len(kernel))])))
    want = np.asarray(jx_conv.conv_pairs_fused(jnp.asarray(flat), packed, n,
                                               interpret=True))
    oracle = _oracle(flat, kernel)
    assert snr_db(want, got.numpy()) >= 100.0
    assert snr_db(oracle, got.numpy()) >= 125.0
    assert snr_db(oracle, got.numpy()) > snr_db(oracle, want)
    assert convpairs.launch_count == 0           # no kernel for a CPU tensor


@pytest.mark.parametrize("n,R", [(16, 1), (32, 2), (64, 5), (128, 3),
                                 (256, 2), (512, 1), (1024, 4), (2048, 3),
                                 (4096, 2)])
def test_numpy_mirror_of_the_cuda_schedule_matches_plain(n, R):
    """csrc/convpairs.cu walked in numpy (pairs of rows as one complex
    window, the odd last row alone, the passes of csrc/window_fft.cuh with
    the plan's own twiddle and spectrum tables) against the plain version
    and float64, at every pass schedule (log2 n even and odd, 0 to 2 outer
    passes)."""
    rng = np.random.default_rng(n + R)
    flat = rng.standard_normal((R, n)).astype(np.float32)
    kernel = rng.standard_normal(rng.integers(1, n + 1)) * 0.1
    plan = convpairs.make_plan(kernel, n, CPU)
    mirror = emulate_convpairs(flat, plan)
    assert np.isfinite(mirror).all()
    plain = convpairs.conv_pairs(torch.from_numpy(flat), plan).numpy()
    assert snr_db(plain, mirror) >= 110.0
    assert snr_db(_oracle(flat, kernel), mirror) >= 95.0


def test_strided_rows_are_taken_as_they_lie():
    """A streaming step passes the first n samples of a longer history."""
    n = 64
    rng = np.random.default_rng(3)
    joined = torch.from_numpy(rng.standard_normal((4, n + 37)
                                                  ).astype(np.float32))
    plan = convpairs.make_plan(rng.standard_normal(9), n, CPU)
    view = joined[:, :n]
    assert not view.is_contiguous()
    assert torch.equal(convpairs.conv_pairs(view, plan),
                       convpairs.conv_pairs(view.contiguous(), plan))


def test_sizes_the_kernel_does_not_take_raise():
    k = np.ones(5)
    for n in (2 * segconv.MAX_WINDOW, 8, 3072, 24576):
        with pytest.raises(ValueError, match=str(n)):
            convpairs.make_plan(k, n, CPU)
    with pytest.raises(ValueError, match="does not fit"):
        convpairs.make_plan(np.ones(65), 64, CPU)
    plan = convpairs.make_plan(k, 64, CPU)
    with pytest.raises(ValueError, match=r"\(R, 64\)"):
        convpairs.conv_pairs(torch.zeros(2, 128), plan)
    with pytest.raises(ValueError, match="float32"):
        convpairs.conv_pairs(torch.zeros(2, 64, dtype=torch.float64), plan)
    assert convpairs.conv_pairs(torch.zeros(0, 64), plan).shape == (0, 64)


# (n, B, lead): the flagship chain's two streaming geometries scaled down
# (B=4096: n = 4 B, lead > 2 B; B=512: n = 4 B, lead > 2 B: the window lies
# wholly in the history), a window that spans history and block, no lead at
# all, and a block as long as the window.
STEP_GEOMETRIES = [(64, 16, 36), (256, 64, 144), (64, 16, 5), (128, 32, 0),
                   (32, 32, 7), (16, 1, 3)]


def _join_convolve_slice(hist, block, plan):
    """The step as it was before the step entry point: join history and
    block, convolve the first n samples of every row, keep the last B; the
    next history is the join from sample B on."""
    B = block.shape[-1]
    joined = torch.cat([hist, block], dim=-1)
    out = convpairs.conv_pairs(joined[:, :plan.n], plan)
    return out[:, plan.n - B:], joined[:, B:]


@pytest.mark.parametrize("n,B,lead", STEP_GEOMETRIES)
@pytest.mark.parametrize("R", [1, 5])
def test_step_equals_join_convolve_slice_over_several_steps(n, B, lead, R):
    """Six steps, the history carried on both sides: EQUAL output and EQUAL
    next history (same window, same plain transform); the old history is
    left as it was; a block that is a slice of a longer signal is taken as
    it lies."""
    rng = np.random.default_rng(n + B + lead + R)
    plan = convpairs.make_plan(rng.standard_normal(n - B + 1) * 0.2, n, CPU)
    H = lead + n - B
    signal = torch.from_numpy(rng.standard_normal((R, 6 * B)
                                                  ).astype(np.float32))
    hist = want_hist = torch.from_numpy(
        rng.standard_normal((R, H)).astype(np.float32))
    for i in range(6):
        block = signal[:, i * B:(i + 1) * B]
        assert R == 1 or not block.is_contiguous()
        before = hist.clone()
        out, new_hist = convpairs.conv_pairs_step(hist, block, plan, lead)
        want, want_hist = _join_convolve_slice(want_hist, block, plan)
        assert out.shape == (R, B) and out.is_contiguous()
        assert new_hist.shape == (R, H) and new_hist.is_contiguous()
        assert torch.equal(out, want) and torch.equal(new_hist, want_hist)
        assert torch.equal(hist, before)             # out of place
        assert new_hist.data_ptr() != hist.data_ptr() or H == 0
        hist = new_hist
    assert convpairs.launch_count == 0           # no kernel for a CPU tensor


@pytest.mark.parametrize("n,B,lead", STEP_GEOMETRIES[:5])
def test_numpy_mirror_of_the_step_entry_point(n, B, lead):
    """csrc/convpairs.cu's step walked in numpy (the branch on the sample
    index that gathers the window from the two arrays, the kept samples, the
    next history read past the window) against the plain version."""
    rng = np.random.default_rng(n * B + lead)
    R = 3
    plan = convpairs.make_plan(rng.standard_normal(n - B + 1) * 0.2, n, CPU)
    hist = rng.standard_normal((R, lead + n - B)).astype(np.float32)
    block = rng.standard_normal((R, B)).astype(np.float32)
    out, nxt = emulate_convpairs_step(hist, block, plan)
    want, want_hist = convpairs.conv_pairs_step(
        torch.from_numpy(hist), torch.from_numpy(block), plan, lead)
    assert out.shape == (R, B) and np.isfinite(out).all()
    assert snr_db(want.numpy(), out) >= 110.0
    np.testing.assert_array_equal(nxt, want_hist.numpy())


def test_step_refuses_what_its_kernel_does_not_take():
    plan = convpairs.make_plan(np.ones(5), 64, CPU)
    hist, block = torch.zeros(2, 51), torch.zeros(2, 16)     # lead 3
    out, new_hist = convpairs.conv_pairs_step(hist, block, plan, 3)
    assert out.shape == (2, 16) and new_hist.shape == (2, 51)
    with pytest.raises(ValueError, match="history"):
        convpairs.conv_pairs_step(hist, block, plan, 4)      # 52 expected
    with pytest.raises(ValueError, match="history"):
        convpairs.conv_pairs_step(hist.double(), block, plan, 3)
    with pytest.raises(ValueError, match="history"):
        convpairs.conv_pairs_step(torch.zeros(51, 2).T, block, plan, 3)
    with pytest.raises(ValueError, match="block"):
        convpairs.conv_pairs_step(hist, block.double(), plan, 3)
    with pytest.raises(ValueError, match="block"):
        convpairs.conv_pairs_step(hist, torch.zeros(16, 2).T, plan, 3)
    with pytest.raises(ValueError, match="B <= 64"):
        convpairs.conv_pairs_step(hist, torch.zeros(2, 65), plan, 3)
    with pytest.raises(ValueError, match="lead"):
        convpairs.conv_pairs_step(torch.zeros(2, 47), block, plan, -1)
    out, new_hist = convpairs.conv_pairs_step(
        torch.zeros(0, 51), torch.zeros(0, 16), plan, 3)
    assert out.shape == (0, 16) and new_hist.shape == (0, 51)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B,lead", [(2048, 512, 1155), (16384, 4096, 9219),
                                      (64, 16, 5), (1024, 1024, 0)])
def test_cuda_step_bit_equal_to_conv_pairs_on_card(n, B, lead):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(n + B)
    plan = convpairs.make_plan(rng.standard_normal(n - B + 1) * 0.1, n, "cuda")
    for R in (1, 5, 64):
        hist = torch.from_numpy(rng.standard_normal((R, lead + n - B)
                                                    ).astype(np.float32)).cuda()
        signal = torch.from_numpy(rng.standard_normal((R, 3 * B)
                                                      ).astype(np.float32)).cuda()
        block = signal[:, B:2 * B]
        before = convpairs.launch_count
        out, new_hist = convpairs.conv_pairs_step(hist, block, plan, lead)
        torch.cuda.synchronize()
        assert convpairs.launch_count == before + 1
        want, want_hist = _join_convolve_slice(hist, block, plan)
        assert torch.equal(out, want) and torch.equal(new_hist, want_hist)
        plain, plain_hist = convpairs.conv_pairs_step(hist, block, plan, lead,
                                                      use_kernels=False)
        assert snr_db(plain.cpu().numpy(), out.cpu().numpy()) >= 110.0
        assert torch.equal(plain_hist, new_hist)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 2048, 16384])
def test_cuda_conv_pairs_matches_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(n)
    kernel = rng.standard_normal(min(n, 1017)) * 0.1
    plan = convpairs.make_plan(kernel, n, "cuda")
    for R in (1, 5, 64):
        flat = rng.standard_normal((R, n)).astype(np.float32)
        xd = torch.from_numpy(flat).cuda()
        before = convpairs.launch_count
        got = convpairs.conv_pairs(xd, plan)
        torch.cuda.synchronize()
        assert convpairs.launch_count == before + 1
        plain = convpairs.conv_pairs(xd, plan, use_kernels=False)
        assert convpairs.launch_count == before + 1
        assert snr_db(plain.cpu().numpy(), got.cpu().numpy()) >= 110.0
        assert snr_db(_oracle(flat, kernel), got.cpu().numpy()) >= 95.0
