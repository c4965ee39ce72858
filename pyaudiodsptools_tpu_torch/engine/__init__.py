"""Engine layer: chain composition and offline rendering."""

from .chain import Chain
from .render import render, render_file

__all__ = ["Chain", "render", "render_file"]
