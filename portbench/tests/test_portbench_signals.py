"""The signal generator is seeded and deterministic, and gives every seed
the same amount of work."""

import numpy as np
import pytest
import torch

from portbench import check, signals

SR = 44100


@pytest.mark.parametrize("signal", [
    {"kind": "burst_noise"},
    {"kind": "bursts_pauses", "burst_s": [0.3, 3.0], "pause_s": [0.2, 2.0],
     "floor_dbfs": -60.0}])
def test_same_seed_same_signal_other_seed_other(signal):
    a = signals.make(signal, 3, 2 * SR, SR, 3_000_000_123, "cpu")
    b = signals.make(signal, 3, 2 * SR, SR, 3_000_000_123, "cpu")
    c = signals.make(signal, 3, 2 * SR, SR, 3_000_000_124, "cpu")
    assert a.dtype == torch.float32 and a.shape == (3, 2 * SR)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= float(np.float32(0.99))


def test_seed_for_takes_seeds_past_32_bits_and_paths():
    s = signals.seed_for(2 ** 33 + 5, 1)
    assert 0 <= s < 2 ** 63
    assert s == signals.seed_for(2 ** 33 + 5, 1) != signals.seed_for(
        2 ** 33 + 5, 2)


def test_bursts_and_pauses_are_one_set_in_another_order():
    """Each seed puts the same burst and pause lengths in its own order:
    the share of pause samples (below the floor) over a whole set of
    lengths is the seed's alone only through where the signal ends."""
    sig = {"kind": "bursts_pauses", "burst_s": [0.3, 3.0],
           "pause_s": [0.2, 2.0], "floor_dbfs": -60.0}
    n = 60 * SR
    shares = []
    for seed in (1, 2, 3):
        x = signals.make(sig, 2, n, SR, seed, "cpu")
        shares.append(float((x.abs() <= 1e-3).float().mean()))
        x2 = signals.make(sig, 2, n, SR, seed + 100, "cpu")
        assert not torch.equal(x, x2)
    assert max(shares) - min(shares) < 0.15
    assert 0.2 < min(shares) and max(shares) < 0.6


def test_pauses_stay_under_the_gate():
    sig = {"kind": "bursts_pauses", "burst_s": [0.3, 3.0],
           "pause_s": [0.2, 2.0], "floor_dbfs": -60.0}
    x = signals.make(sig, 4, 20 * SR, SR, 9, "cpu")
    quiet = x.abs() <= 10 ** (-60 / 20)
    assert bool(quiet.any())
    assert float(x[quiet].abs().max()) < 10 ** (-45 / 20)


def test_sampled_channels_take_one_from_each_group():
    for seed in (1, 2, 2 ** 32 + 7):
        chans = check.sample_channels(256, 4, seed)
        assert [c // 64 for c in chans] == [0, 1, 2, 3]
        assert chans == check.sample_channels(256, 4, seed)
    assert check.sample_channels(3, 8, 1) == sorted(
        check.sample_channels(3, 8, 1))


def test_sampled_jobs_are_distinct_and_below_the_bound():
    jobs = check.sample_jobs(3, 50, 11)
    assert len(set(jobs)) == 3 and max(jobs) < 50
    assert jobs == check.sample_jobs(3, 50, 11)
    assert check.sample_jobs(2, 1, 4) == [0, 1]
