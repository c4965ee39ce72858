"""The reader of the program's capture counter, ``graph.capture_s``."""

import sys
import types

from portbench import spec
from portbench.record import Run

GRAPH = "pyaudiodsptools_tpu_torch.engine.graph"


def read(rec):
    return spec.reader("graph.capture_s")(rec)


def test_capture_seconds_read_from_the_program(monkeypatch):
    graph = types.ModuleType(GRAPH)
    graph.capture_s = 0.75
    monkeypatch.setitem(sys.modules, GRAPH, graph)
    assert read(Run("c", "offline")) == 0.75
    assert read(Run("c", "stream")) == 0.75
    # a sharded run's captures are its ranks', other processes
    assert read(Run("c", "sharded")) is None


def test_no_counter_reads_nothing(monkeypatch):
    """A program without the counter (an older commit) or not loaded."""
    monkeypatch.setitem(sys.modules, GRAPH, types.ModuleType(GRAPH))
    assert read(Run("c", "offline")) is None
    monkeypatch.delitem(sys.modules, GRAPH)
    assert read(Run("c", "stream")) is None
