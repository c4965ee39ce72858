"""pyaudiodsptools_tpu_torch -- the PyTorch/CUDA port of pyaudiodsptools_tpu.

A second package beside the JAX one, for an NVIDIA H100: effects are pure
``(params, state, block) -> (state, block)`` functions over torch tensors,
chains fuse LTI runs into one segmented convolution, compressor / gate runs
into one cascade of speculative segment-parallel walks, and delay / tremolo /
waveshaper runs into one tail pass, and all of those run as CUDA C++ kernels
written by hand for sm_90a (``csrc/``, built at first use). Streaming steps
block by block through two more: the circular convolution of the FIR window
and the serial dynamics walk, the whole step captured once in a CUDA graph
and replayed a block (the counterpart of the JAX package's jitted step). It
imports
``torch`` and ``numpy``, and nothing of JAX or of the JAX package.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``; on
a CPU tensor every kernel-backed effect runs its plain PyTorch version.

Layers:
  core      config and device resolution, blocking, wav I/O, generators,
            gain / dBV / dither utilities, meters
  ops       the effect library: every effect of the JAX package
  kernels   CUDA kernel wrappers, plain versions, and the nvcc build
  engine    Chain composition and fusion, offline render, StreamProcessor
            and the captured step it replays, segmented and resumable
            render
  runtime   realtime: native SPSC rings and a pump thread around the
            streaming step, and a PortAudio duplex adapter
  parallel  one process a device over ``torch.distributed``: the
            (channel, time) mesh and the sharded render, with every halo
            and gather an explicit exchange
  convert   build a chain from a plain numpy description of its params
  compat    drop-in ``pyAudioDspTools`` API (``Create*().apply(chunk)``)
  profiling per-effect profiler scopes (``annotate_chain``), a
            TensorBoard trace (``trace``), the program's own spans and the
            captured graphs' stage marks (``enable``), read back by
            ``attribute``
  roofline  the kernels' cost models, the H100's peaks, a call's bound and
            its share of each roofline

``runtime``, ``parallel``, ``profiling`` and ``roofline`` are imported by
name (``pyaudiodsptools_tpu_torch.runtime``), as in the JAX package.

``python -m pyaudiodsptools_tpu_torch in.wav out.wav --chain '<json>'``
renders a wav file through a chain.
"""

from .core.config import EngineConfig, resolve_device
from .core import block, generators, metering, utility, wavio
from . import ops
from .engine import (Chain, StreamProcessor, render, render_file,
                     render_resumable, render_segmented)
from . import compat, convert

__version__ = "0.1.0"

__all__ = [
    "EngineConfig", "resolve_device", "block", "generators", "metering",
    "utility", "wavio", "ops", "Chain",
    "render", "render_file", "render_segmented", "render_resumable",
    "StreamProcessor", "compat", "convert",
]
