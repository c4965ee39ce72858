"""PyTorch/CUDA port, the command-line renderer
(``python -m pyaudiodsptools_tpu_torch``): a generated 2-channel wav through
a chain of every kind of stage, ``--device cpu``, against the JAX package's
CLI on the same file and spec."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pyaudiodsptools_tpu.__main__ import main as jx_main
from pyaudiodsptools_tpu_torch.__main__ import build_chain, main as pt_main
from pyaudiodsptools_tpu_torch.core import wavio

from torch_port_util import snr_db

SPEC = [
    {"op": "lowcut", "cutoff_hz": 120.0},
    {"op": "eq3band", "low_shelf_hz": 200.0, "low_shelf_db": 3.5,
     "mid_hz": 1000.0, "mid_db": -2.5, "high_shelf_hz": 8000.0,
     "high_shelf_db": 4.0},
    {"op": "compressor", "threshold_db": -18.0},
    {"op": "delay", "time_in_ms": 60.0, "feedback_loops": 2},
    {"op": "reverb", "time_in_ms": 200.0},
    {"op": "softclipper"},
]


def _wav(path: Path, seed: int = 0, seconds: float = 0.75) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(44100 * seconds)
    env = (np.sin(2 * np.pi * np.arange(n) / 5000.0) > 0) * 0.4 + 0.02
    x = np.clip(rng.standard_normal((2, n)) * env, -0.95, 0.95)
    wavio.write_wav(str(path), x, 44100)
    return x


@pytest.mark.parametrize("extra", [[], ["--trim"]],
                         ids=["render", "trim"])
def test_cli_matches_jax_cli(tmp_path, extra):
    _wav(tmp_path / "in.wav")
    args = ["--chain", json.dumps(SPEC), "--block-size", "512", *extra]
    assert pt_main([str(tmp_path / "in.wav"), str(tmp_path / "pt.wav"),
                    *args, "--device", "cpu"]) == 0
    assert jx_main([str(tmp_path / "in.wav"), str(tmp_path / "jx.wav"),
                    *args]) == 0
    got, rate = wavio.read_wav(str(tmp_path / "pt.wav"))
    want, _ = wavio.read_wav(str(tmp_path / "jx.wav"))
    assert rate == 44100 and got.shape == want.shape
    assert got.shape[0] == 2
    if extra:
        assert got.shape[1] == int(44100 * 0.75)
    assert np.abs(got).max() > 0.05
    assert snr_db(want, got) >= 90.0


def test_build_chain_takes_every_op_of_the_jax_cli():
    from pyaudiodsptools_tpu_torch.core.config import EngineConfig

    names = ["lowcut", "highcut", "eq3band_fft", "eq3band", "compressor",
             "gate", "delay", "tremolo", "reverb", "saturator", "softclipper",
             "harddistortion", "bitcrusher"]
    chain = build_chain(EngineConfig(44100, 512), [{"op": n} for n in names
                                                    if n not in ("eq3band",
                                                                 "eq3band_fft")],
                        device="cpu")
    assert len(chain) == len(names) - 2
    with pytest.raises(SystemExit, match="unknown op"):
        build_chain(EngineConfig(44100, 512), [{"op": "flanger"}], "cpu")


def test_module_entry_point_renders(tmp_path):
    _wav(tmp_path / "in.wav", seed=1, seconds=0.2)
    out = subprocess.run(
        [sys.executable, "-m", "pyaudiodsptools_tpu_torch",
         str(tmp_path / "in.wav"), str(tmp_path / "out.wav"), "--device",
         "cpu", "--block-size", "512"],
        capture_output=True, text=True, cwd=Path(__file__).parent.parent,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "on cpu" in out.stdout
    y, _ = wavio.read_wav(str(tmp_path / "out.wav"))
    assert y.shape[0] == 2
