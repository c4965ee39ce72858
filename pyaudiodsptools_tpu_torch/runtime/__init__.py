"""Realtime runtime: native SPSC rings and a pump thread around the chain's
streaming step, and an import-gated PortAudio duplex adapter."""

from . import native_lib
from .portaudio import DuplexAudioStream, available_backend
from .realtime import RealtimeEngine

__all__ = ["native_lib", "RealtimeEngine", "DuplexAudioStream",
           "available_backend"]
