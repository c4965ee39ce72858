"""PyTorch/CUDA port, the relayout kernels' wrappers (``kernels/relayout.py``):
natural (C, T) <-> segment-major time-major (L, Rp), against the JAX
package's Pallas kernels in interpret mode and as exact round trips.

On the CPU the wrappers run their plain versions (pad / reshape / permute);
the CUDA kernels are held to the same plain versions on the card
(``chip_smoke.py`` and the ``cuda``-marked test below).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyaudiodsptools_tpu.kernels import relayout as jx_rl
from pyaudiodsptools_tpu_torch.kernels import relayout as rl


def _jax_geometry(C, T, segments):
    """A geometry the JAX kernels accept, as tests/test_relayout.py builds
    it: L a multiple of 128, lanes rounded to 8 * 128."""
    unit = 128
    L = -(-max(unit, -(-T // segments)) // unit) * unit
    G = -(-T // L)
    R = C * G
    Rp = -(-R // 1024) * 1024
    return G, L, R, Rp, Rp // 8


@pytest.mark.parametrize("T", [64 * 64 * 4, 64 * 64 * 4 + 777])
def test_pack_matches_the_jax_kernel_where_it_writes(T):
    """The JAX array (L*8, K) is the same memory as a row-major (L, Rp).
    Compared on lanes < C*G and rows that hold a sample: the JAX kernel
    leaves its pad lanes uninitialised. The port's are exactly zero."""
    C = 64
    G, L, R, Rp, K = _jax_geometry(C, T, 4)
    assert jx_rl.use_relayout(C, T, G, L, K, R, Rp)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((C, T)).astype(np.float32)
    want = np.asarray(jx_rl.time_major_pack(jnp.asarray(x), G, L, K,
                                            interpret=True)).reshape(L, Rp)
    got = rl.pack(torch.from_numpy(x), G, L, Rp).numpy()
    assert got.shape == (L, Rp) and got.dtype == np.float32
    lane = np.arange(Rp)[None, :]
    valid = (lane < R) & ((lane // C) * L + np.arange(L)[:, None] < T)
    np.testing.assert_array_equal(got[valid], want[valid])
    assert valid.sum() == C * T
    assert not got[~valid].any()
    # and the JAX unpack of the port's pack gives the signal back
    back = jx_rl.time_major_unpack(jnp.asarray(got.reshape(L * 8, K)), C, T,
                                   G, L, interpret=True)
    np.testing.assert_array_equal(np.asarray(back), x)


@pytest.mark.parametrize("segments", [1, 4, 7])
@pytest.mark.parametrize("C", [1, 3, 64])
def test_roundtrip_exact_and_pads_zero(C, segments):
    T = 5037                                   # ragged for 4 and 7 segments
    G, L, Rp = rl.geometry(C, T, segments)
    assert Rp % rl.LANE_MULTIPLE == 0 and Rp >= C * G
    rng = np.random.default_rng(C * 10 + segments)
    x = torch.from_numpy(rng.standard_normal((C, T)).astype(np.float32))
    tm = rl.pack(x, G, L, Rp)
    assert tm.shape == (L, Rp) and tm.is_contiguous()
    # lane r = g*C + c, row l: sample g*L + l of channel c
    for g, c, l in ((0, 0, 0), (G - 1, C - 1, 0), (G // 2, C // 2, L - 1)):
        if g * L + l < T:
            assert tm[l, g * C + c] == x[c, g * L + l]
    assert not bool(tm[:, C * G:].any())                  # pad lanes
    assert not bool(tm[T - (G - 1) * L:, (G - 1) * C:].any())   # ragged rows
    back = rl.unpack(tm, C, T, G, L)
    assert back.shape == (C, T) and back.is_contiguous()
    assert torch.equal(back, x)
    assert torch.equal(rl.pack(x, G, L, Rp, use_kernels=False), tm)


def test_cpu_tensors_launch_no_kernel():
    before = (rl.pack_launch_count, rl.unpack_launch_count)
    G, L, Rp = rl.geometry(2, 300, 3)
    rl.unpack(rl.pack(torch.zeros((2, 300)), G, L, Rp), 2, 300, G, L)
    assert (rl.pack_launch_count, rl.unpack_launch_count) == before


def test_wrappers_refuse_bad_requests():
    x = torch.zeros((2, 300))
    G, L, Rp = rl.geometry(2, 300, 3)
    with pytest.raises(ValueError, match="float32"):
        rl.pack(x.double(), G, L, Rp)
    with pytest.raises(ValueError, match="contiguous"):
        rl.pack(torch.zeros((300, 2)).T, G, L, Rp)
    with pytest.raises(ValueError, match="tile the signal"):
        rl.pack(x, G + 1, L, Rp + 32)        # an empty last segment
    with pytest.raises(ValueError, match="tile the signal"):
        rl.pack(x, G - 1, L, Rp)             # segments that stop short of T
    with pytest.raises(ValueError, match="lanes"):
        rl.pack(x, G, L, 2 * G - 1)
    with pytest.raises(ValueError, match="float32"):
        rl.unpack(torch.zeros((L + 1, Rp)), 2, 300, G, L)
    with pytest.raises(ValueError, match="bad relayout request"):
        rl.geometry(0, 300, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 64])
def test_cuda_kernels_equal_plain_on_card(C):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    T = 50037
    G, L, Rp = rl.geometry(C, T, 7)
    x = torch.randn((C, T), device="cuda")
    before = (rl.pack_launch_count, rl.unpack_launch_count)
    tm = rl.pack(x, G, L, Rp)
    back = rl.unpack(tm, C, T, G, L)
    torch.cuda.synchronize()
    assert (rl.pack_launch_count, rl.unpack_launch_count) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(tm, rl.pack_plain(x, G, L, Rp))
    assert torch.equal(back, x)
