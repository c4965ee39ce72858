"""Command-line renderer: ``python -m pyaudiodsptools_tpu_torch in.wav out.wav``.

Counterpart of ``pyaudiodsptools_tpu/__main__.py``, with ``--device``: the
render runs on the card (``cuda``) unless ``--device cpu`` is given. Chains
are described as JSON op specs:

    python -m pyaudiodsptools_tpu_torch in.wav out.wav \\
        --block-size 4096 \\
        --chain '[{"op": "lowcut", "cutoff_hz": 800},
                  {"op": "compressor", "threshold_db": -18},
                  {"op": "softclipper"}]'

Op names and keyword arguments are those of the factories in
``pyaudiodsptools_tpu_torch.ops``, the same as the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_chain(cfg, spec: list[dict], device="cuda"):
    from . import ops
    from .engine import Chain

    factories = {
        "lowcut": ops.lowcut, "highcut": ops.highcut,
        "eq3band_fft": ops.eq3band_fft, "eq3band": ops.eq3band,
        "compressor": ops.compressor, "gate": ops.gate, "delay": ops.delay,
        "tremolo": ops.tremolo, "reverb": ops.reverb,
        "saturator": ops.saturator, "softclipper": ops.softclipper,
        "harddistortion": ops.harddistortion, "bitcrusher": ops.bitcrusher,
    }
    effects = []
    for item in spec:
        item = dict(item)
        name = item.pop("op")
        if name not in factories:
            raise SystemExit(f"unknown op '{name}'; choose from "
                             f"{sorted(factories)}")
        effects.append(factories[name](cfg, **item, device=device))
    return Chain(effects, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pyaudiodsptools_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input", help="input wav (8/16/24/32-bit PCM)")
    ap.add_argument("output", help="output wav (16-bit PCM)")
    ap.add_argument("--chain", default='[{"op": "lowcut", "cutoff_hz": 160}]',
                    help="JSON list of op specs")
    ap.add_argument("--block-size", type=int, default=4096)
    ap.add_argument("--sample-rate", type=int, default=None,
                    help="override; default = input file rate")
    ap.add_argument("--trim", action="store_true",
                    help="trim output to input length (no block padding)")
    ap.add_argument("--segment-blocks", type=int, default=None,
                    help="bounded-memory exact render: process in segments "
                         "of this many blocks (for very long inputs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the render (default: cuda)")
    args = ap.parse_args(argv)

    from .core import wavio
    from .core.config import EngineConfig
    from .engine.render import render, render_segmented

    audio, rate = wavio.read_wav(args.input)
    cfg = EngineConfig(sample_rate=args.sample_rate or rate,
                       block_size=args.block_size)
    chain = build_chain(cfg, json.loads(args.chain), args.device)

    t0 = time.perf_counter()
    if args.segment_blocks:
        out = render_segmented(chain, audio, cfg,
                               segment_blocks=args.segment_blocks,
                               trim=args.trim)
    else:
        out = render(chain, audio, cfg, trim=args.trim)
    out = out.cpu().numpy()
    dt = time.perf_counter() - t0
    wavio.write_wav(args.output, out, cfg.sample_rate)

    dur = audio.shape[-1] / cfg.sample_rate
    print(f"rendered {dur:.2f}s x{audio.shape[0] if audio.ndim > 1 else 1}ch "
          f"through {len(chain)} effects on {chain.device} in {dt:.3f}s "
          f"({dur / dt:.1f}x realtime) -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
