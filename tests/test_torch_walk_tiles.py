"""PyTorch/CUDA port: the offline dynamics walks' tile schedule.

csrc/dynamics.cu's offline walks read the (C, T) signal as it lies: a thread
block takes rows of the (C*G, L) view (segment g of channel c is row
c*G + g), stages tiles of samples through a ring of shared-memory slots and
walks each row; the audio walk stores its output tile back into (C, T). The
numpy mirror of that schedule (``torch_port_util.emulate_tile_walk``) is
held to the plain walks (``kernels/dynamics.segments_plain``) bit for bit,
and the stage to the earlier design (pack, walks on the time-major copy,
unpack), on the CPU."""

import numpy as np
import pytest
import torch

import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu_torch.kernels import dynamics as kd, relayout as rl

from torch_port_util import emulate_tile_walk

CPU = "cpu"
PCFG = pt.EngineConfig(44100, 512)
# name -> (factory name, arguments), as in tests/test_torch_dynamics.py
OPS = {
    "chain8_compressor": ("compressor", (-18.0, 0.6, 3.1, 30.1)),
    "chain8_gate": ("gate", (-45.0, 0.1, 3.1, 200.1)),
    "short_attack": ("compressor", (-20.0, 0.5, 1000.0 / 44100.0, 2.0)),
}
N = 12000       # longer than the gate's release (8,824 samples)


def _pt(name):
    fac, args = OPS[name]
    return getattr(pt.ops, fac)(PCFG, *args, device=CPU)


def _decay():
    """Short bursts followed by silence (the signal of
    tests/test_torch_dynamics.py): the gate's release spans many segments."""
    decay = np.zeros((2, N), np.float32)
    decay[:, 100:400] = 0.5
    decay[1, 9500:9600] = -0.5
    return decay


# 1 to 4 ops: a lone gate, the flagship pair, and longer cascades with the
# one-sample attack inside
TILE_CASCADES = {
    1: ("chain8_gate",),
    2: ("chain8_compressor", "chain8_gate"),
    3: ("chain8_gate", "short_attack", "chain8_compressor"),
    4: ("chain8_gate", "short_attack", "chain8_compressor", "chain8_gate"),
}
# name -> (C, T, segments, rows a block, samples a tile row)
TILE_SHAPES = {
    # T % G != 0: the last segment is ragged; L = 720 is no multiple of the
    # tile (22.5 tiles); C*G = 21 rows, one block of the kernel's 128
    "ragged": (3, 5037, 7, kd.TILE_ROWS, kd.TILE_K),
    # the kernel's constants over two blocks, the second short: C*G = 150
    # rows (128 + 22), L = 60 (1.9 tiles), T = 2,999 (ragged)
    "two_blocks": (3, 2999, 50, kd.TILE_ROWS, kd.TILE_K),
    # blocks of 8 rows over 21 (8, 8, 5) and tiles of 12 samples over 720
    "small_blocks": (3, 5037, 7, 8, 12),
    # one segment a channel (the serial walk), a row shorter than a tile
    "one_segment": (2, 27, 1, kd.TILE_ROWS, kd.TILE_K),
}


def _tile_signal(C, T, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, T)) * 0.3
            * (rng.random((C, T)) > 0.5)).astype(np.float32)


@pytest.mark.parametrize("shape", TILE_SHAPES)
@pytest.mark.parametrize("n_ops", TILE_CASCADES)
def test_tile_schedule_mirror_equals_plain_walks(n_ops, shape):
    """The numpy mirror of the offline walks' schedule (blocks of rows of
    the (C*G, L) view, tiles through a ring, zeros past T, stores masked)
    against the plain walks: audio and exit states BIT-equal, for the audio
    walk and the state walk, from REST and from random legal entries."""
    C, T, segments, rows, k = TILE_SHAPES[shape]
    params = [_pt(n).params for n in TILE_CASCADES[n_ops]]
    scalars = [kd.op_scalars(p) for p in params]
    G, L, _ = rl.geometry(C, T, segments)
    x = _tile_signal(C, T, seed=n_ops * 7 + len(shape))
    xt = torch.from_numpy(x)
    rng = np.random.default_rng(n_ops)
    for entry in (np.zeros((n_ops, C * G), np.int32),
                  np.stack([rng.integers(-1, sc[7], C * G) for sc in scalars]
                           ).astype(np.int32)):
        e = torch.from_numpy(entry)
        out, z = kd.audio_walk(scalars, xt, G, L, e)
        m_out, m_z = emulate_tile_walk(scalars, x, G, L, entry,
                                       tile_rows=rows, tile_k=k)
        np.testing.assert_array_equal(m_out, out.numpy())     # no NaN left
        np.testing.assert_array_equal(m_z, z.numpy())
        _, m_zs = emulate_tile_walk(scalars, x, G, L, entry, audio=False,
                                    tile_rows=rows, tile_k=k)
        np.testing.assert_array_equal(m_zs,
                                      kd.state_walk(scalars, xt, G, L, e))
        np.testing.assert_array_equal(m_zs, m_z)


def _relayout_stage(params, x: torch.Tensor, segments: int) -> torch.Tensor:
    """The offline stage as it ran before its walks read (C, T): the
    time-major copy (relayout.pack, lanes padded to a warp), the fixpoint
    loop of walks on it, and relayout.unpack, all as plain versions."""
    C, T = x.shape
    scalars = [kd.op_scalars(p) for p in params]
    G, L, Rp = rl.geometry(C, T, segments)
    R = C * G
    tm = rl.pack(x, G, L, Rp, use_kernels=False)

    def next_entries(z):
        e = torch.zeros_like(z)
        e[:, C:R] = z[:, :R - C]
        return e

    e = next_entries(kd.walk_plain(scalars, tm, torch.zeros(
        (len(params), Rp), dtype=torch.int32), audio=False)[1])
    while True:
        out, z = kd.walk_plain(scalars, tm, e, audio=True)
        if torch.equal(next_entries(z), e):
            return rl.unpack(out, C, T, G, L, use_kernels=False)
        e = next_entries(z)


@pytest.mark.parametrize("shape", ["ragged", "two_blocks", "decay"])
@pytest.mark.parametrize("n_ops", [1, 2, 4])
def test_offline_stage_bit_equal_to_the_relayout_path(n_ops, shape):
    """``dynamics_offline``, which walks (C, T) as it lies, against the
    stage of the earlier design (pack, walks on the time-major copy,
    unpack): bit-equal. "decay" is the burst-then-silence signal whose
    gate release hands its state on through 13 walks at 16 segments."""
    params = [_pt(n).params for n in TILE_CASCADES[n_ops]]
    if shape == "decay":
        x, segments = _decay(), 16
    else:
        C, T, segments, _, _ = TILE_SHAPES[shape]
        x = _tile_signal(C, T, seed=n_ops)
    xt = torch.from_numpy(x)
    got = kd.dynamics_offline(params, xt, segments=segments)
    assert torch.equal(got, _relayout_stage(params, xt, segments))


def test_tile_schedule_mirror_walks_the_loop_to_the_serial_result():
    """The whole stage with the mirror's walks on the burst-then-silence
    signal at 16 segments (blocks of 8 rows, tiles of 32): one state walk
    then audio walks until the shifted exits equal the entries; 13 walks in
    all, and the result is the serial one."""
    params = [_pt(n).params for n in TILE_CASCADES[2]]
    scalars = [kd.op_scalars(p) for p in params]
    x = _decay()
    C, T = x.shape
    G, L, _ = rl.geometry(C, T, 16)
    R = C * G

    def shift(z):
        e = np.zeros_like(z)
        e[:, C:R] = z[:, :R - C]
        return e

    _, z = emulate_tile_walk(scalars, x, G, L, np.zeros((2, R), np.int32),
                             audio=False, tile_rows=8)
    e, walks = shift(z), 1
    while True:
        out, z = emulate_tile_walk(scalars, x, G, L, e, tile_rows=8)
        walks += 1
        if np.array_equal(shift(z), e):
            break
        e = shift(z)
    assert walks == 13
    serial = kd.dynamics_offline(params, torch.from_numpy(x), segments=1)
    np.testing.assert_array_equal(out, serial.numpy())


