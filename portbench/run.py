#!/usr/bin/env python3
"""Run one cell of the benchmark of ``pyaudiodsptools_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for (``BENCHMARK.json``). The cell's configuration, traffic mix, metric
readers and limits are files under ``portbench/`` found by name
(``portbench/spec.py``). The run makes its inputs from the seed, warms up
(set-up), measures for ``--seconds``, checks the sampled outputs against
the plain reference (``portbench/reference/``) and prints, as the last
line of its standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``, each compared number beside its limit
(also the last lines of standard error).

Exits non-zero and prints no result without the cards, when the port's
package is missing, or when ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``pyaudiodsptools_tpu`` is loaded once the window has closed, in
this process or in a rank of a sharded cell.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Top-level module names that may not be loaded: JAX and the JAX package
# (compared whole: the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "pyaudiodsptools_tpu")


def forbidden_modules(modules=None) -> list[str]:
    names = {m.split(".")[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cards_missing(chips: int) -> str | None:
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device: torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, this machine has "
                f"{torch.cuda.device_count()}")
    return None


def main(argv=None, device: str = "cuda", patch: dict | None = None,
         root: str = ROOT) -> int:
    """One run. ``device`` and ``patch`` (keyword arguments for the loop:
    a replacement for the timed call) exist for the tests, which drive a
    run on the CPU with the timed path broken underneath."""
    from portbench import check, spec

    args = parse(argv)
    cell = spec.cell(args.workload, root=root)
    from portbench.loops import common
    common.host_threads(cell.config)
    if device == "cuda":
        missing = cards_missing(cell.chips)
        if missing:
            print(f"portbench: {missing}", file=sys.stderr)
            return 3
    loop = importlib.import_module(f"portbench.loops.{cell.traffic['loop']}")
    rec, after = loop.run(cell, args.seed, args.seconds, bool(args.trace),
                          device, T_START, **(patch or {}))
    found = forbidden_modules() + after.get("forbidden", [])
    if found:
        print(f"portbench: loaded after the window: {found}", file=sys.stderr)
        return 4
    rec.device_name = rec.device_name or device_name(device)
    t0 = time.perf_counter()
    numbers = after["compare"]()
    print(f"portbench: check {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    correct, shown = check.verdict(numbers, cell.limits)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.reader(m["name"], cell.here)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": rec.device_name,
           "count": cell.chips, "memory_peak_bytes": rec.peak_reserved}
    line = {"correct": correct, "attempted": rec.units,
            "failed": sum(1 for s in shown.values()
                          if s["value"] is None or s["value"] > s["limit"]),
            "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"], dev["window_s"] = busy_window(rec)
        line["breakdown"] = rec.profile["breakdown"]
    line["check"] = shown
    for name, s in shown.items():
        print(f"check {name}: {s['value']} (limit {s['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def device_name(device: str) -> str:
    if device != "cuda":
        return device
    import torch
    return torch.cuda.get_device_name()


def busy_window(rec) -> tuple[float, float]:
    """Device-busy seconds averaged over the chips used, and the traced
    window's length."""
    if rec.ranks:
        profiles = [r["profile"] for r in rec.ranks]
        return (sum(p["busy_s"] for p in profiles) / len(profiles),
                rec.profile["window_s"])
    return rec.profile["busy_s"], rec.profile["window_s"]


if __name__ == "__main__":
    sys.exit(main())
