#!/usr/bin/env python3
"""The correctness check's control: the plain reference computed in
bfloat16 (the nearest precision below the float32 the configurations
state) put in the program's place, read by the same number the runs
compare, on the inputs and channels a run of the cell samples.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--steps N]

On the card at the cell's own size (no program runs: one card serves
every cell); ``--device cpu`` and the tests run it small. Prints one JSON
line a seed. The benchmark's runs do not run it; its readings are the
upper ends the limits in ``limits/<cell>.json`` were set below.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def reading(cell, seed: int, device, steps: int | None = None) -> dict:
    """The compared numbers of the bfloat16 reference against the float64
    one, for ``seed``'s first job (offline, sharded) or its first
    ``steps`` steps (stream)."""
    import torch
    from portbench import check, signals
    from portbench.loops import common

    config, traffic = cell.config, cell.traffic
    B = int(traffic["block_size"])
    C = int(config["channels"])
    sr = int(config["sample_rate"])
    chans = check.sample_channels(C, int(traffic["check"]["groups"]), seed)
    if traffic["loop"] == "stream":
        nblk = max(1, int(round(float(traffic["signal_seconds"]) * sr / B)))
        x = signals.make(traffic["signal"], C, nblk * B, sr, seed,
                         device)[chans]
        steps = steps or nblk
        x = x.repeat(1, -(-steps // nblk))[:, :steps * B]
        n = steps * B
    else:
        n = common.samples(config)
        x = signals.make(traffic["signal"], C, n, sr,
                         signals.seed_for(seed, 0), device)[chans]
        x = torch.nn.functional.pad(x, (0, -(-n // B) * B - n))
    want = check.reference(config, x, B)[:, :n]
    got = check.reference(config, x, B, "bfloat16")[:, :n]
    return {"seed": seed, "channels": chans, "samples": n,
            **check.numbers([check.rel_errs(got, want)])}


def main(argv=None) -> int:
    from portbench import spec
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": cell.name,
                          **reading(cell, seed, args.device, args.steps)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
