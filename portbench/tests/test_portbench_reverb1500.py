"""The cell ``reverb1500.offline`` on the CPU at its configuration's test
size, and its FIR readers on synthetic traces."""

import pytest

from conftest import result_line
from portbench import run, spec
from portbench.record import Run


def test_the_reverb_cell_runs_correct(checkout, capsys):
    rc = run.main(["--workload", "reverb1500.offline", "--seed",
                   "3000000017", "--seconds", "1", "--trace", "0"],
                  device="cpu", root=checkout)
    line = result_line(capsys.readouterr().out)
    assert rc == 0
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert {"render_samples_per_s", "setup_s"} <= set(line["metrics"])


def rec(launches, jobs):
    return Run("reverb1500.offline", "offline", traced_units=jobs,
               profile={"by_name": {"segconv_kernel": [launches, 0.7]}})


@pytest.mark.parametrize("launches, jobs, want", [(600, 120, 5.0),
                                                  (7, 2, 3.5)])
def test_segconv_launches_per_job_is_launches_over_traced_jobs(
        launches, jobs, want):
    read = spec.reader("fir.segconv_launches_per_job")
    assert read(rec(launches, jobs)) == want


def test_segconv_launches_per_job_reads_nothing_without_launches():
    read = spec.reader("fir.segconv_launches_per_job")
    assert read(rec(0, 3)) is None
    assert read(rec(5, 0)) is None
    assert read(Run("c", "offline", traced_units=3)) is None
    stream = Run("c", "stream", traced_units=3,
                 profile={"by_name": {"segconv_kernel": [3, 0.1]}})
    assert read(stream) is None
