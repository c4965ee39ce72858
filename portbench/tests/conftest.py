"""Shared fixtures of the benchmark's tests: a small copy of the
benchmark's data (every configuration cut to its own ``test_size``, a few
channels and seconds) in a temporary checkout, which the CPU runs of the
harness use."""

import glob
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH_DIR = os.path.join(ROOT, "portbench")
DATA_DIRS = ("configs", "traffic", "limits", "metrics")


def cut_to_test_size(config: dict) -> dict:
    """The configuration at the size its ``test_size`` gives."""
    if "test_size" not in config:
        raise KeyError(f"configuration {config.get('name')!r} has no "
                       "test_size (channels and length_s for the CPU tests)")
    return {**config, **config["test_size"]}


def small_checkout(path, src: str = ROOT) -> str:
    """A checkout at ``path`` holding ``BENCHMARK.json`` and the
    benchmark's data files of the checkout ``src``, every configuration
    cut to its test size."""
    os.makedirs(os.path.join(path, "portbench"), exist_ok=True)
    shutil.copy(os.path.join(src, "BENCHMARK.json"), path)
    for d in DATA_DIRS:
        shutil.copytree(os.path.join(src, "portbench", d),
                        os.path.join(path, "portbench", d))
    for p in glob.glob(os.path.join(path, "portbench", "configs", "*.json")):
        with open(p) as f:
            config = json.load(f)
        with open(p, "w") as f:
            json.dump(cut_to_test_size(config), f)
    return str(path)


@pytest.fixture
def checkout(tmp_path):
    return small_checkout(tmp_path / "checkout")


def result_line(out: str) -> dict:
    """The last line of a run's standard output, parsed."""
    return json.loads(out.strip().splitlines()[-1])
