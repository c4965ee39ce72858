"""The program's own counter of the host's seconds in CUDA-graph captures
(``engine/graph.py``: ``capture_s``, warm-up and capture, every graph this
process captured), read at the end of the run: the part of set-up that the
captures take. None where the program has no such counter, and in a
sharded run, whose ranks are other processes."""

import sys

GRAPH = "pyaudiodsptools_tpu_torch.engine.graph"


def read(rec):
    if rec.loop not in ("offline", "stream"):
        return None
    return getattr(sys.modules.get(GRAPH), "capture_s", None)
