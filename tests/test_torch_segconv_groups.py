"""The segmented convolution's owned schedule (``csrc/segconv.cu`` through
``csrc/window_fft.cuh``'s ``convolve_levels_owned``): below the top pass of
a window over a cluster each run of points belongs to the same threads in
every pass, and only the threads that share points wait for each other
between two passes. A window in one block keeps a block barrier after every
pass.

On the CPU, from the kernel's thread-to-point maps (``torch_port_util.
owned_schedule``) and the group width of ``kernels/segconv.py``: no point is
touched by two threads in one pass, every point a pass reads was written by
the previous pass in the reader's own warp or group where only a warp or
group barrier lies between them, and the transform run group by group is
bit-equal to the lockstep one. On a card (``cuda``; imports no JAX, so
``python -m pytest --noconftest -m cuda tests/test_torch_segconv_groups.py``
runs there): the same launch ten times gives the same bits, and
``compute-sanitizer``'s racecheck and synccheck, where the machine has it,
find no hazard in one small launch of each version."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyaudiodsptools_tpu_torch.kernels import segconv

from torch_port_util import emulate_window_fft, owned_schedule, snr_db

# every window from the smallest a cluster takes (256) to the largest,
# in every version (thread blocks a window pair) the kernel has for it
WINDOWS = [(n, b) for n in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                            65536)
           for b in segconv.versions(n)]
# hardware barriers of a block, one of them __syncthreads'
HW_BARRIERS = 16


@pytest.mark.parametrize("n,blocks", WINDOWS)
def test_owned_schedule_waits_for_every_writer(n, blocks):
    sch = owned_schedule(n, blocks)
    threads, width, passes = sch["threads"], sch["width"], sch["passes"]
    if blocks > 1:
        assert width == segconv.owner_threads(n, blocks)
    else:                       # one block: a block barrier after each pass
        assert {p["barrier"] for p in passes} == {"block"}
    assert threads % width == 0 and width % 32 == 0
    # a group barrier of its own for each group, besides the block's
    assert threads // width <= HW_BARRIERS - 1
    for p in passes:
        # each point of the block touched by one thread alone: no two
        # threads, so no two groups, write one point in one pass
        assert (p["owner"] >= 0).all(), p["name"]
    for a, b in zip(passes, passes[1:]):
        unit = {"warp": 32, "group": width}.get(a["barrier"])
        if unit is None:            # a block or cluster barrier between
            continue
        # the thread that reads a point in b is in the warp (group) of the
        # one that wrote it in a
        same = a["owner"] // unit == b["owner"] // unit
        assert same.all(), (a["name"], b["name"], a["barrier"])
    # the levels below a cluster's top pass end at the cluster's barrier
    # (the top pass's adjoint reads every group's points)
    assert passes[-1]["barrier"] == ("cluster" if blocks > 1 else "block")


@pytest.mark.parametrize("n,blocks", WINDOWS)
def test_owned_mirror_is_bit_equal_to_block_wide(n, blocks):
    """The owned levels run one group to its end before the next (the last
    group first) give the lockstep one-block schedule's bits: no group
    reads what another writes between two block barriers."""
    rng = np.random.default_rng(n * blocks + 19)
    plan = segconv.make_plan(rng.standard_normal(n // 4) * 0.1, n // 4,
                             n - n // 4, 0, "cpu")
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    lockstep = emulate_window_fft(z, plan)
    assert np.isfinite(lockstep).all()
    np.testing.assert_array_equal(
        emulate_window_fft(z, plan, blocks, owned=True), lockstep)


def test_group_constants_match_the_header():
    path = os.path.join(os.path.dirname(segconv.__file__), "..", "csrc",
                        "window_fft.cuh")
    with open(path) as f:
        text = f.read()
    defined = dict(re.findall(r"#define (WINDOW_FFT_\w+) (\d+)", text))
    assert int(defined["WINDOW_FFT_THREADS"]) == segconv.BLOCK_THREADS
    assert int(defined["WINDOW_FFT_OWNER_THREADS"]) == segconv.OWNER_THREADS
    # the widths the clusters of the offline FIRs take: 8 groups of 128 in
    # a cluster of two, 4 of 256 in one of four
    assert [segconv.owner_threads(n, b) for n, b in
            ((32768, 2), (65536, 4))] == [128, 256]


# (n, halo, blocks): each version at the widths the offline FIRs take
CARD_WINDOWS = [(16384, 1408, 1), (32768, 16384, 2), (65536, 8192, 4),
                (8192, 1024, 1), (2048, 256, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("n,halo,blocks", CARD_WINDOWS)
def test_repeated_launches_are_bit_equal_on_card(n, halo, blocks,
                                                 accumulate):
    """A missing barrier shows as bits that change from launch to launch:
    ten launches on ragged rows that start off a 16-byte boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(n + blocks + accumulate)
    k = rng.standard_normal(halo - 5) * 0.05
    plan = segconv.make_plan(k, halo, n - halo, 37, "cuda")
    C, T = 5, 4 * n + 7
    buf = torch.from_numpy(rng.standard_normal(C * T + 1).astype(
        np.float32)).cuda()
    x = buf[1:].view(C, T)               # rows misaligned from the first
    base = torch.from_numpy(rng.standard_normal((C, T)).astype(
        np.float32)).cuda()
    outs = []
    for _ in range(10):
        if accumulate:
            y = base.clone()
            segconv._launch(x, plan, blocks, into=y)
        else:
            y = segconv._launch(x, plan, blocks)
        outs.append(y)
    torch.cuda.synchronize()
    for y in outs[1:]:
        assert torch.equal(y, outs[0])
    plain = segconv.segmented_conv(x, plan, use_kernels=False)
    if accumulate:
        plain = plain + base
    assert snr_db(plain.cpu().numpy(), outs[0].cpu().numpy()) >= 110.0


# one small launch of each version, writing and accumulating, for the
# sanitizer (each block of 1,024 threads, a few window pairs)
SANITIZED = """
import torch
from pyaudiodsptools_tpu_torch.kernels import segconv
for n, halo, blocks in {windows}:
    k = torch.linspace(-1.0, 1.0, halo - 5, dtype=torch.float64).numpy()
    plan = segconv.make_plan(k, halo, n - halo, 3, "cuda")
    x = torch.randn(1, 2 * n + 7, device="cuda")
    y = segconv._launch(x, plan, blocks)
    segconv._launch(x, plan, blocks, into=y)
torch.cuda.synchronize()
"""


@pytest.mark.cuda
@pytest.mark.parametrize("tool", ["racecheck", "synccheck"])
def test_sanitizer_finds_no_hazard_on_card(tool):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    exe = shutil.which("compute-sanitizer") or next(
        (p for p in ("/usr/local/cuda/bin/compute-sanitizer",)
         if os.path.exists(p)), None)
    if exe is None:
        pytest.skip("compute-sanitizer is not installed on this machine")
    segconv._launch(torch.zeros(1, 64, device="cuda"), segconv.make_plan(
        np.ones(3), 16, 48, 0, "cuda"))        # built before the sanitizer
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = SANITIZED.format(windows=CARD_WINDOWS[:3])
    run = subprocess.run(
        [exe, "--tool", tool, "--error-exitcode", "3",
         "--kernel-name", "kns=segconv_kernel", sys.executable, "-c",
         script], cwd=root, capture_output=True, text=True, timeout=900)
    out = run.stdout + run.stderr
    if "Device not supported" in out:
        # the tool runs nothing on such a card: there is no result to hold
        pytest.skip("compute-sanitizer does not support this device")
    assert run.returncode == 0, out[-4000:]
    assert "ERROR SUMMARY: 0 errors" in out, out[-4000:]
