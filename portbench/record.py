"""What one run of a cell leaves for the metric readers."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Run:
    cell: str
    loop: str                     # "offline", "stream" or "sharded"
    device_name: str = ""
    setup_s: float = 0.0          # process start to the first timed job
    window_s: float = 0.0         # the measured window, host clock
    units: int = 0                # jobs or steps completed in the window
    samples: int = 0              # channel-samples of unpadded input done
    host_ms: list = field(default_factory=list)    # each job or step
    call_ms: list = field(default_factory=list)    # render call returned
    device_ms: list = field(default_factory=list)  # CUDA events (traced)
    walks: list = field(default_factory=list)      # per job (traced)
    peak_reserved: int = 0        # bytes, the fullest chip
    geometry: dict = field(default_factory=dict)   # shapes for rooflines
    profile: dict | None = None   # trace.summarise of the traced window
    traced_units: int = 0         # jobs or steps inside the traced window
    ranks: list = field(default_factory=list)      # sharded: each rank's
