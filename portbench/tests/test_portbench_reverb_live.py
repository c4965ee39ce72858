"""The cell ``reverb_live.stream512_pauses`` on the CPU at its
configuration's test size, and its streamed FIR's readers on synthetic
traces."""

import pytest

from conftest import result_line
from portbench import roofline, run, spec
from portbench.record import Run

CELL = "reverb_live.stream512_pauses"
H100 = "NVIDIA H100 80GB HBM3"
# the fused lowcut + reverb's stripped taps at B = 512
TAPS = 65287


def test_the_live_reverb_cell_runs_correct(checkout, capsys):
    rc = run.main(["--workload", CELL, "--seed", "3000000041", "--seconds",
                   "1", "--trace", "0"], device="cpu", root=checkout)
    line = result_line(capsys.readouterr().out)
    assert rc == 0
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert {"step_ms", "setup_s"} <= set(line["metrics"])


def rec(launches, steps, seconds=0.5, loop="stream", cell=CELL):
    return Run(cell, loop, device_name=H100, traced_units=steps,
               geometry={"C": 64, "T": 512, "n": 512, "B": 512},
               profile={"by_name": {"convpairs_kernel": [launches,
                                                         seconds]}})


@pytest.mark.parametrize("launches, steps, want", [(7148, 3574, 2.0),
                                                   (5, 2, 2.5)])
def test_convpairs_launches_per_step_is_launches_over_traced_steps(
        launches, steps, want):
    read = spec.reader("fir.convpairs_launches_per_step")
    assert read(rec(launches, steps)) == want


def test_convpairs_launches_per_step_reads_nothing_without_launches():
    read = spec.reader("fir.convpairs_launches_per_step")
    assert read(rec(0, 3)) is None
    assert read(rec(6, 0)) is None
    assert read(rec(6, 3, loop="offline")) is None
    assert read(Run(CELL, "stream", traced_units=3)) is None


def test_the_frozen_bound_counts_the_history_and_the_block_once():
    """4 R (K - 1 + 3 B) bytes a step at this cell's K, R and B: the
    history and the block read, the block written into the state and the
    output written, 5.11 us a step at the H100's HBM peak."""
    read = spec.reader("kernel.convpairs_parts.roofline_pct")
    assert read.__globals__["lti_taps"](CELL, read.__globals__["ROOT"],
                                        512) == TAPS
    assert read.__globals__["step_bytes"](64, 512, TAPS) == 17106432
    hbm, _ = roofline.PEAKS[H100]
    steps, seconds = 3574, 0.5
    assert read(rec(2 * steps, steps, seconds)) == pytest.approx(
        100.0 * steps * 17106432 / hbm / seconds, rel=1e-12)
    assert 17106432 / hbm == pytest.approx(5.106e-6, rel=1e-3)


def test_the_frozen_bound_reads_nothing_off_the_stream():
    read = spec.reader("kernel.convpairs_parts.roofline_pct")
    assert read(rec(6, 3, loop="offline")) is None
    assert read(rec(0, 3)) is None
    assert read(rec(6, 0)) is None
    assert read(Run(CELL, "stream", traced_units=3)) is None
