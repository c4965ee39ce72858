"""The segmented convolution's store (``csrc/segconv.cu``: ``bulk_store``,
``add_store``), on the CPU through its numpy mirror
(``torch_port_util.emulate_segconv_store``).

A writing launch lays each window's whole 16-byte chunks of output into the
block's shared memory as two runs and hands them to bulk copies, storing the
few other points alone; an accumulating launch loads every chunk of the
output it adds into before its first add. Held here, for reverb1500's and
chain8's partition geometries and the small windows, output delays that are
not a multiple of 4, rows that start off a 16-byte boundary, short and ragged
rows, the first, a middle and the last pair and every block of a cluster:
every output sample of the block is stored once, with the value the store a
point at a time gives (bit for bit); the runs start on 16-byte boundaries,
are whole chunks long, lie inside [shift, T) and fit the block's window; a
thread's points and chunks fit the kernel's registers. The card's checks of
the same kernel: ``chip_smoke.py`` (``conv_cases``, every version held to
its plain version and the clusters to one block) and
``tests/test_torch_segconv_groups.py`` (repeated launches bit-equal, writing
and accumulating)."""

import os
import re

import numpy as np
import pytest

from pyaudiodsptools_tpu_torch.kernels import segconv

from torch_port_util import emulate_segconv_store

# (n, halo, blocks, shift): reverb1500's five partitions (output delays 2, 3,
# 0, 1 and 2 past a multiple of 4), chain8's FIR, the window over four and
# the small windows of one block and of a cluster
GEOMETRIES = [(32768, 16384, 2, 3734), (32768, 16384, 2, 20119),
              (32768, 16384, 2, 36504), (32768, 16384, 2, 52889),
              (16384, 1408, 1, 69274), (32768, 8192, 2, 4093),
              (65536, 8192, 4, 9219), (8192, 1024, 1, 1155),
              (2048, 256, 2, 7), (16, 4, 1, 3)]


def point_store(z, y, oa, seg, i_lo, T, shift, has_b, accumulate):
    """The store a point at a time (``store1`` for every point)."""
    wins = [(oa, z.real.astype(np.float32))]
    if has_b:
        wins.append((oa + seg, z.imag.astype(np.float32)))
    for o0, v in wins:
        for i in range(i_lo, len(z)):
            o = o0 + i
            if o >= T:
                continue
            if o < shift:
                if not accumulate:
                    y[o] = 0.0
            else:
                y[o] = y[o] + v[i] if accumulate else v[i]
    return y


def blocks_of(n, halo, blocks, shift, T):
    """(oa, has_b, i_lo, m) of every block of the first, a middle and the
    last pair of a row."""
    m = n // blocks
    seg = n - halo
    n_seg = -(-T // seg)
    pairs = (n_seg + 1) // 2
    for p in sorted({0, pairs // 2, pairs - 1}):
        s0 = 2 * p
        for rank in range(blocks):
            base = rank * m
            i_lo = max(0, halo - base)
            if i_lo < m:
                yield s0 * seg + base - halo, s0 + 1 < n_seg, i_lo, m


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("n,halo,blocks,shift", GEOMETRIES)
def test_store_writes_each_output_once_as_a_point_store_would(
        n, halo, blocks, shift, accumulate):
    seg = n - halo
    threads = segconv.block_threads(n // blocks)
    rng = np.random.default_rng(n + halo + shift + accumulate)
    for T in (3 * n + 7, seg + 5, 3 * seg + 2):
        for phase in range(4):
            for oa, has_b, i_lo, m in blocks_of(n, halo, blocks, shift, T):
                z = (rng.standard_normal(m)
                     + 1j * rng.standard_normal(m)).astype(np.complex64)
                row = rng.standard_normal(T).astype(np.float32)
                if not accumulate:
                    row[:] = np.nan
                got = row.copy()
                done = emulate_segconv_store(z, got, phase, oa, seg, i_lo,
                                             threads, T, shift, has_b,
                                             accumulate)
                want = point_store(z, row.copy(), oa, seg, i_lo, T, shift,
                                   has_b, accumulate)
                np.testing.assert_array_equal(got, want)
                # once each, and only inside the row
                assert all(k == 1 for k in done["touched"].values())
                assert all(0 <= o < T for o in done["touched"])
                at = 0
                for o, length, off in done["runs"]:
                    assert (phase + o) % 4 == 0 and length % 4 == 0
                    assert shift <= o and o + length <= T
                    assert off == at and off % 4 == 0   # one after another
                    at += length
                # both runs fit the block's window in shared memory
                assert at <= 2 * (m + m // 16)


@pytest.mark.parametrize("n,blocks", [(n, b) for n in (16, 256, 512, 2048,
                                                       4096, 16384, 32768,
                                                       65536)
                                      for b in segconv.versions(n)])
def test_a_thread_holds_its_points_and_chunks(n, blocks):
    m = n // blocks
    threads = segconv.block_threads(m)
    # the writing store's registers: SEGCONV_POINTS points a thread
    assert m <= 16 * threads
    # the accumulating store's: SEGCONV_CHUNKS chunks a window a thread
    assert m // 4 <= 4 * threads


def test_store_constants_match_the_source():
    path = os.path.join(os.path.dirname(segconv.__file__), "..", "csrc",
                        "segconv.cu")
    with open(path) as f:
        text = f.read()
    defined = dict(re.findall(r"#define (SEGCONV_\w+) (\d+)\n", text))
    assert int(defined["SEGCONV_POINTS"]) == 16
    assert int(defined["SEGCONV_CHUNKS"]) == 4
    assert "cp.async.bulk.global.shared::cta.bulk_group" in text
    assert "cp.async.bulk.wait_group.read 0" in text
