"""Engine layer: chain composition, offline rendering and streaming."""

from .chain import Chain
from .render import render, render_file, render_segmented
from .resumable import render_resumable
from .stream import StreamProcessor

__all__ = ["Chain", "render", "render_file", "render_segmented",
           "render_resumable", "StreamProcessor"]
