"""Build the port's effects from a plain numpy description.

``chain_from_numpy(spec, device)`` takes a list with one dict per effect:

    {"op": <effect name>, "meta": {<static fields>},
     "params": {<field>: numpy array}, "lti_kernel": float64 array or None}

which is what one gets from an effect of the JAX package by taking
``np.asarray`` of every array leaf of its params, its static fields as they
are, and its ``lti_kernel`` as float64. This module imports no JAX: whoever
holds the JAX effects (the parity tests) does the extraction.

What is carried across, per effect:

* FIR effects (``lowcut``, ``highcut``, ``eq3band_fft``, ``fir``, fused
  cascades): ``lti_kernel`` and ``meta["block_size"]`` -- not the JAX
  package's spectra, because the port plans its own window and builds its own
  spectrum from the same float64 kernel;
* ``delay``: ``ramp``, and ``time_in_samples``, ``feedback_loops``, ``wet``,
  ``block_size`` (pre-filter variants are built with ``ops.delay``);
* ``tremolo``: ``lfo``, ``omega``, ``depth``, and ``lfo_length``,
  ``block_size``;
* waveshapers: their scalars (``coeff``, ``makeup``, ``mode``; ``drive``);
* ``compressor`` / ``gate``: ``threshold``, ``pre_gain``, ``attack_env``,
  ``release_env``, and ``x_max``, ``y_max``;
* ``eq3band`` / ``eq_band_low`` / ``_mid`` / ``_high``: ``coeffs`` and
  ``coeffs_lo`` (the JAX package's float64 coefficients as f32 head and
  tail), summed in float64, and ``block_size``;
* ``reverb``: ``lti_kernel`` (the combined kernel, which offline runs), and
  per line (``meta["line1"]``, ``meta["line2"]``) ``time_in_samples`` and
  ``n_taps``, its ``ramp`` (``params["line1"]["ramp"]``, ...), with
  ``meta["sample_rate"]``, which the JAX params do not carry and the
  lines' high-cuts are designed for. The lines' kernels at that rate must
  sum to ``lti_kernel``, or the conversion raises: a description at another
  rate does not convert with the wrong high-cuts. It is handled before the
  FIR branch:
  built as a plain ``fir`` it would stream through another structure than
  the JAX reverb's two lines.

The port's own factories give the same params; ``tests/test_torch_chain.py``
holds them to that.

``state_from_numpy(chain, leaves)`` carries a STREAMING state across: the
leaves of a JAX chain state as numpy arrays, in ``jax.tree.flatten`` order
(which is the order of the port's ``engine.stream.state_leaves``, whatever
runs either chain fused). Dynamics fields, delay and reverb buffers and the
tremolo's position (two 0-d int32 leaves, shared by every channel) are the
same on both sides. A FIR history is not (also a
reverb line's high-cut's): the JAX step keeps ``halo_stream`` whole blocks
for its own window, the port keeps the samples its windows reach back
(``fft_filter.history_len``), so the history is cut from the end of the JAX
one and padded with silence in front where the JAX one is shorter (those
samples meet no tap that reaches an output still to come). An EQ's state
words are (hi, lo) float32 pairs on the JAX side (``x1``, ``x1l``, ...) and
one float64 here: each pair is summed in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.config import DEFAULT_DEVICE, EngineConfig, resolve_device
from .engine.chain import Chain
from .engine.stream import state_from_leaves, state_paths
from .ops import dynamics, fft_filter, waveshapers as ws
from .ops.base import Effect, host_scalar
# ``ops.delay`` / ``ops.tremolo`` name the factories; the modules behind them:
from .ops.delay import DelayParams, make_effect as make_delay, tap_kernel
from .ops.eq3band import EQ3BandParams, from_rows as eq_from_rows
from .ops.reverb import (LINES as REVERB_LINES, ReverbLineParams,
                         ReverbParams, lines_kernel as reverb_lines_kernel,
                         make_effect as make_reverb)
from .ops.tremolo import (TremoloParams, init_state as tremolo_init_state,
                          offline as tremolo_offline, step as tremolo_step)


def _scalar(value) -> torch.Tensor:
    return host_scalar(np.asarray(value, dtype=np.float32).reshape(()))


def effect_from_numpy(entry: dict, device=DEFAULT_DEVICE) -> Effect:
    """One effect from its description (see the module docstring)."""
    dev = resolve_device(device)
    op = entry["op"]
    meta = entry.get("meta", {})
    params = entry.get("params", {})
    if op == "delay":
        if meta.get("use_lowcut") or meta.get("use_highcut"):
            raise ValueError(
                "a delay with pre-filters is not carried as numpy params; "
                "build it with ops.delay(...)")
        ramp = np.asarray(params["ramp"], dtype=np.float32)
        p = DelayParams(
            ramp=torch.from_numpy(ramp.copy()), lowcut=None, highcut=None,
            time_in_samples=int(meta["time_in_samples"]),
            feedback_loops=int(meta["feedback_loops"]),
            wet=bool(meta["wet"]), block_size=int(meta["block_size"]),
            use_lowcut=False, use_highcut=False)
        kernel = tap_kernel(ramp, p.time_in_samples, p.wet)
        return make_delay(p, kernel, dev)
    if op == "reverb":
        kernel = np.asarray(entry["lti_kernel"], np.float64)
        B = int(meta["block_size"])
        cfg = EngineConfig(sample_rate=int(meta["sample_rate"]), block_size=B)
        lines, described = [], []
        for key, (_loops, hz) in zip(("line1", "line2"), REVERB_LINES):
            ramp = np.asarray(params[key]["ramp"], dtype=np.float32)
            n_taps = int(meta[key]["n_taps"])
            time = int(meta[key]["time_in_samples"])
            described.append((time, ramp, n_taps, hz))
            lines.append(ReverbLineParams(
                ramp=torch.from_numpy(ramp.copy()),
                gains=torch.from_numpy(ramp[:n_taps].copy()).to(dev),
                highcut=fft_filter.highcut(cfg, hz, device=dev).params,
                time_in_samples=time, n_taps=n_taps, block_size=B))
        mine = reverb_lines_kernel(cfg, described)
        if mine.shape != kernel.shape or not np.allclose(
                mine, kernel, rtol=0.0, atol=1e-9 * np.abs(kernel).max()):
            raise ValueError(
                f"the reverb's lines at {cfg.sample_rate} Hz do not sum to "
                "its lti_kernel: its high-cuts were designed for another "
                "sample rate")
        p = ReverbParams(
            line1=lines[0], line2=lines[1],
            full=fft_filter.fir(kernel, B, device=dev).params, block_size=B)
        return make_reverb(p, kernel, dev)
    if op == "eq3band" or op.startswith("eq_band_"):
        rows = (np.asarray(params["coeffs"], np.float64)
                + np.asarray(params["coeffs_lo"], np.float64))
        return eq_from_rows(rows, int(meta["block_size"]), op, dev)
    if entry.get("lti_kernel") is not None:
        return fft_filter.fir(np.asarray(entry["lti_kernel"], np.float64),
                              int(meta["block_size"]), name=op, device=dev)
    if op == "tremolo":
        p = TremoloParams(
            lfo=torch.from_numpy(
                np.asarray(params["lfo"], dtype=np.float32).copy()).to(dev),
            omega=_scalar(params["omega"]), depth=_scalar(params["depth"]),
            lfo_length=int(meta["lfo_length"]),
            block_size=int(meta["block_size"]))
        return Effect(name="tremolo", params=p,
                      init_state=tremolo_init_state,
                      step=tremolo_step, offline=tremolo_offline,
                      device=dev, block_indexed=True)
    if op in ("compressor", "gate"):
        p = dynamics.DynamicsParams(
            threshold=_scalar(params["threshold"]),
            pre_gain=_scalar(params["pre_gain"]),
            attack_env=torch.from_numpy(
                np.asarray(params["attack_env"], dtype=np.float32).copy()),
            release_env=torch.from_numpy(
                np.asarray(params["release_env"], dtype=np.float32).copy()),
            x_max=int(meta["x_max"]), y_max=int(meta["y_max"]))
        return dynamics.make_effect(op, p, dev)
    if op == "saturator":
        p = ws.SaturatorParams(coeff=_scalar(params["coeff"]),
                               makeup=_scalar(params["makeup"]),
                               mode=int(meta["mode"]))
        return ws._stateless(op, p, ws._saturate, dev)
    if op == "softclipper":
        p = ws.SoftClipperParams(drive=_scalar(params["drive"]))
        return ws._stateless(op, p, ws._softclip, dev)
    if op == "harddistortion":
        return ws.harddistortion(None, device=dev)
    if op == "bitcrusher":
        return ws.bitcrusher(None, device=dev)
    raise ValueError(f"effect {op!r} is not part of the port")


def chain_from_numpy(spec, device=DEFAULT_DEVICE, fuse: bool = True) -> Chain:
    """A :class:`Chain` on ``device`` from a list of effect descriptions."""
    dev = resolve_device(device)
    return Chain([effect_from_numpy(entry, dev) for entry in spec],
                 fuse=fuse, device=dev)


def state_from_numpy(chain: Chain, jax_state_leaves):
    """The port's streaming state of ``chain`` from the numpy leaves of the
    JAX chain's state for the same effects (see the module docstring)."""
    bare = state_paths(chain.init_state(()))
    eq = {i for i, e in enumerate(chain.exec_effects)
          if isinstance(e.params, EQ3BandParams)}
    # an EQ's (hi, lo) words, adjacent in the JAX order (x1, x1l, x2, ...),
    # become one float64
    it = iter(np.asarray(leaf) for leaf in jax_state_leaves)
    leaves = []
    try:
        for path, _ in bare:
            leaf = next(it)
            if path[0] in eq:
                leaf = leaf.astype(np.float64) + next(it).astype(np.float64)
            leaves.append(leaf)
    except StopIteration:
        raise ValueError("too few state leaves for this chain") from None
    if next(it, None) is not None:
        raise ValueError("too many state leaves for this chain")
    # The batch shape is whatever a leaf that has one carries besides its own
    # axes (a JAX FIR history has two of its own, blocks and samples, behind
    # it; an EQ word has the bands in front of it). The tremolo's position
    # has none: its leaves keep their shape whatever the batch.
    probe = state_paths(chain.init_state((1,)))
    batch_shape = ()
    for (path, own), (_, one), leaf in zip(bare, probe, leaves):
        if one.dim() == own.dim():
            continue
        if path[0] in eq:
            batch_shape = tuple(leaf.shape[1:])
        else:
            own_axes = 2 if path[-1] == "hist" else own.dim()
            batch_shape = tuple(leaf.shape[:leaf.ndim - own_axes])
        break
    template = state_paths(chain.init_state(batch_shape))
    converted = []
    for (path, own), leaf in zip(template, leaves):
        if path[-1] == "hist":
            flat = leaf.reshape(batch_shape + (-1,)).astype(np.float32)
            keep = own.shape[-1]
            flat = flat[..., max(flat.shape[-1] - keep, 0):]
            pad = keep - flat.shape[-1]
            leaf = np.pad(flat, [(0, 0)] * len(batch_shape) + [(pad, 0)])
        converted.append(leaf)
    return state_from_leaves(chain.init_state(batch_shape), converted)
