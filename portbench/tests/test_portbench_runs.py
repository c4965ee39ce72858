"""Whole runs of the harness on the CPU at a small size: a cell added in a
copy by adding files and entries only; the timed path broken underneath
(each fault a cell can have) and ``correct`` coming out false; the
command without a card and in a directory that holds only the benchmark.
The runs skip the harness's look for a card (``run.main(device="cpu")``);
on the card the ``cuda`` test drives one small cell there."""

import filecmp
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import BENCH_DIR, DATA_DIRS, ROOT, result_line, small_checkout
from portbench import run
from portbench.loops.stream import WARM_STEPS


def go(checkout, cell, capsys, seconds="1", trace="0", **patch):
    rc = run.main(["--workload", cell, "--seed", "3000000017", "--seconds",
                   seconds, "--trace", trace], device="cpu", root=checkout,
                  patch=patch or None)
    out = capsys.readouterr().out
    assert rc == 0
    return result_line(out)


@pytest.mark.parametrize("cell", ["chain8.offline_repeat", "chain8.stream512",
                                  "dynstrip.offline_pauses"])
def test_sound_runs_are_correct(checkout, capsys, cell):
    line = go(checkout, cell, capsys)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert list(line)[-1] == "check"
    assert "setup_s" in line["metrics"]


def test_traced_run_reports_per_layer_metrics(checkout, capsys):
    line = go(checkout, "dynstrip.offline_pauses", capsys, trace="1")
    assert line["correct"] is True
    assert "entry.render_call_ms.offline" in line["metrics"]
    assert "render_samples_per_s" not in line["metrics"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_added_by_files_and_entries_only(tmp_path, capsys):
    """A throwaway configuration, traffic mix, metric and cell: new files
    and new BENCHMARK.json entries in a copy of the benchmark; every file
    the benchmark had stays byte for byte, and the tests' small checkout
    cuts the new configuration by its own test size."""
    full = tmp_path / "full"
    bench_dir = os.path.join(full, "portbench")
    os.makedirs(bench_dir)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), full)
    for d in DATA_DIRS:
        shutil.copytree(os.path.join(BENCH_DIR, d), os.path.join(bench_dir, d))
    before = tmp_path / "before"
    shutil.copytree(bench_dir, before)
    with open(os.path.join(bench_dir, "configs", "lowcut_only.json"),
              "w") as f:
        json.dump({"name": "lowcut_only", "source": "test", "sample_rate":
                   44100, "channels": 64, "length_s": 600.0,
                   "precision": "float32", "reduced": [],
                   "effects": [{"op": "lowcut", "cutoff_hz": 200.0},
                               {"op": "softclipper", "drive": 0.44}],
                   "test_size": {"channels": 2, "length_s": 1.0}}, f)
    with open(os.path.join(bench_dir, "traffic", "tiny_blocks.json"),
              "w") as f:
        json.dump({"loop": "offline", "block_size": 1024, "ring": 1,
                   "signal": {"kind": "burst_noise", "level": 0.5},
                   "check": {"jobs": 1, "groups": 2},
                   "trace_seconds": None}, f)
    with open(os.path.join(bench_dir, "limits",
                           "lowcut_only.tiny_blocks.json"), "w") as f:
        json.dump({"worst_channel_rel_err": {"limit": 1e-4},
                   "median_channel_rel_err": {"limit": 1e-5}}, f)
    with open(os.path.join(bench_dir, "metrics", "jobs_done.py"), "w") as f:
        f.write("def read(rec):\n    return float(rec.units)\n")
    with open(os.path.join(full, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "lowcut_only", "source": "test",
                             "file": "portbench/configs/lowcut_only.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "lowcut_only.tiny_blocks",
                               "config": "lowcut_only",
                               "traffic": "tiny_blocks", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "jobs_done", "unit": "jobs",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["lowcut_only.tiny_blocks"]})
    for m in bench["end_to_end"]:
        if m["name"] == "render_samples_per_s":
            m["workloads"].append("lowcut_only.tiny_blocks")
    with open(os.path.join(full, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    root = small_checkout(tmp_path / "checkout", src=str(full))
    line = go(root, "lowcut_only.tiny_blocks", capsys)
    assert line["correct"] is True
    assert line["metrics"]["jobs_done"]["value"] == line["attempted"]
    done = line["metrics"]["render_samples_per_s"]["value"]
    assert done > 0 and line["attempted"] >= 1
    cmp = filecmp.dircmp(before, bench_dir)
    assert not cmp.diff_files and not cmp.left_only
    for sub in cmp.common_dirs:
        assert not cmp.subdirs[sub].diff_files


# ---------------------------------------------------------------------------
# faults in the timed path: module-level, so that the sharded loop's
# spawned ranks can take them


def _half_batch(out):
    """Half of the channels left out: their rows are the rendered half's."""
    h = out.shape[0] // 2
    out = out.clone()
    out[h:2 * h] = out[:h]
    return out


def _altered(out, block):
    """One block of every channel altered where it is produced."""
    out = out.clone()
    flat = out.reshape(out.shape[0], -1)
    flat[:, 3 * block:4 * block] *= -1.0
    return out


def render_half_batch(chain, x, cfg):
    from pyaudiodsptools_tpu_torch import render
    return _half_batch(render(chain, x, cfg))


def render_altered(chain, x, cfg):
    from pyaudiodsptools_tpu_torch import render
    return _altered(render(chain, x, cfg), cfg.block_size)


def sharded_half_batch(rend, x):
    return _half_batch(rend.render(x))


def sharded_altered(rend, x):
    return _altered(rend.render(x), rend.cfg.block_size)


def sharded_no_exchange(rend, x):
    """Each rank's own channels only: the gather's exchange left out."""
    out = rend.render(x)
    c = rend.mesh.shape["channel"]
    per = out.shape[0] // c
    ci, _ = rend.mesh.coords
    keep = torch.zeros_like(out)
    keep[ci * per:(ci + 1) * per] = out[ci * per:(ci + 1) * per]
    return keep


def sharded_loads_jax(rend, x):
    """A rank that holds a module named ``jax`` after its window."""
    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return rend.render(x)


def step_state_unchanged(sp, block):
    """Every block from rest: the step returns its state unchanged."""
    sp.reset()
    return sp.process(block)


def step_half_batch(sp, block):
    out = sp.process(block)
    h = out.shape[0] // 2
    out[h:2 * h] = out[:h]
    return out


_steps = {"n": 0}


def step_altered(sp, block):
    out = sp.process(block)
    _steps["n"] += 1
    if _steps["n"] == WARM_STEPS + 3:      # the third step in the window
        out = -out
    return out


@pytest.mark.parametrize("cell, patch", [
    ("chain8.offline_repeat", {"render": render_half_batch}),
    ("chain8.offline_repeat", {"render": render_altered}),
    ("dynstrip.offline_pauses", {"render": render_half_batch}),
    ("dynstrip.offline_pauses", {"render": render_altered}),
    ("chain8.stream512", {"process": step_state_unchanged}),
    ("chain8.stream512", {"process": step_half_batch}),
    ("chain8.stream512", {"process": step_altered}),
], ids=["offline-half-batch", "offline-altered", "dynstrip-half-batch",
        "dynstrip-altered", "stream-state-unchanged", "stream-half-batch",
        "stream-altered"])
def test_a_broken_timed_path_is_not_correct(checkout, capsys, cell, patch):
    _steps["n"] = 0
    line = go(checkout, cell, capsys, **patch)
    assert line["correct"] is False and line["failed"] >= 1
    shown = line["check"]["worst_channel_rel_err"]
    assert shown["value"] > shown["limit"]


def test_the_sharded_cell_is_correct_over_four_cpu_ranks(checkout, capsys):
    line = go(checkout, "chain8_256ch.sharded_4x1", capsys, seconds="2")
    assert line["correct"] is True
    assert line["device"]["count"] == 4
    assert line["check"]["ranks_differing"]["value"] == 0


@pytest.mark.parametrize("fault", [sharded_no_exchange, sharded_half_batch,
                                   sharded_altered],
                         ids=["no-exchange", "half-batch", "altered"])
def test_a_broken_sharded_render_is_not_correct(checkout, capsys, fault):
    line = go(checkout, "chain8_256ch.sharded_4x1", capsys, seconds="2",
              render=fault)
    assert line["correct"] is False


def test_a_rank_with_jax_loaded_gives_no_result(checkout, capsys):
    rc = run.main(["--workload", "chain8_256ch.sharded_4x1", "--seed",
                   "3000000017", "--seconds", "1", "--trace", "0"],
                  device="cpu", root=checkout,
                  patch={"render": sharded_loads_jax})
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == ""
    assert "jax (rank 0)" in err and "jax (rank 3)" in err


# ---------------------------------------------------------------------------
# the command itself


def test_the_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "run.py"),
                        "--workload", "chain8.offline_repeat", "--seed", "1",
                        "--seconds", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_command_alone_with_the_benchmark_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "chain8.offline_repeat", "--seed", "1", "--seconds",
                        "1"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_cuda_a_small_offline_cell_on_the_card(checkout, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rc = run.main(["--workload", "dynstrip.offline_pauses", "--seed", "7",
                   "--seconds", "1"], device="cuda", root=checkout)
    line = result_line(capsys.readouterr().out)
    assert rc == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert np.isfinite(line["metrics"]["render_samples_per_s"]["value"])
