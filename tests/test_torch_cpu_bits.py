"""PyTorch/CUDA port: one plain CPU render, one answer.

The plain convolutions (``kernels/segconv.segmented_conv_plain``: torch.fft
over an ``unfold`` of the overlap-save windows, MKL's batched DFT) gave other
bits for one or two windows in some processes: fresh processes that had run
a JAX render first, several at once, with torch's default threads.
``tests/torch_port_util.py`` keeps the test processes to one torch thread;
this file holds that: the chain7 plan's FIR stage and the whole render,
repeated in fresh processes under that condition, give the bits of this
process.

Run as a script (``python test_torch_cpu_bits.py <out.npz>``) it is one such
process: the JAX chain7 render first, then the port's."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (the thread pins)

B = 512
PROCESSES = 8
AT_ONCE = 4
TIMEOUT_S = 240


def _chain7(pkg, cfg, **kw):
    o = pkg.ops
    return [o.lowcut(cfg, 120.0, **kw), o.highcut(cfg, 12000.0, **kw),
            o.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5, **kw),
            o.saturator(cfg, **kw), o.delay(cfg, 150.0, 2, **kw),
            o.tremolo(cfg, 0.3, 5.0, **kw), o.softclipper(cfg, 0.44, **kw)]


def _signal():
    """tests/test_torch_chain.py's input of ``test_chain7_render_matches_jax``
    at B=512: 3 channels of 40 blocks less 100 samples."""
    n = 40 * B - 100
    rng = np.random.default_rng(B)
    x = rng.standard_normal((3, n)) * 0.25
    t = np.arange(n)
    burst = (np.sin(2 * np.pi * t / (44100 // 3)) > 0.6) * 0.5 + 0.3
    return np.clip(x * burst, -0.99, 0.99).astype(np.float32)


def port_results() -> dict:
    """The FIR stage three times and the render twice, on the CPU."""
    import pyaudiodsptools_tpu_torch as pt
    from pyaudiodsptools_tpu_torch.kernels import segconv

    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_chain7(pt, cfg, device="cpu"), device="cpu")
    x = _signal()
    padded = torch.nn.functional.pad(torch.from_numpy(x), (0, 100))
    plans = chain.exec_effects[0].params.plans
    out = {f"fir{i}": segconv.partitioned_conv(padded, plans,
                                               use_kernels=False).numpy()
           for i in range(3)}
    out["render0"] = pt.render(chain, x, cfg).numpy()
    out["render1"] = pt.render(chain, x, cfg, use_kernels=False).numpy()
    return out


def main(out_path: str) -> None:
    import jax.numpy as jnp

    import pyaudiodsptools_tpu as jx
    from pyaudiodsptools_tpu.core import block as jx_block

    jcfg = jx.EngineConfig(44100, B)
    jchain = jx.Chain(_chain7(jx, jcfg))
    blocks = jx_block.make_blocks(jnp.asarray(_signal()), B)
    np.asarray(jchain.render_blocks(blocks))
    np.savez(out_path, threads=torch.get_num_threads(), **port_results())


def test_the_test_processes_keep_torch_to_one_thread():
    assert torch.get_num_threads() == 1


def test_chain7_fir_stage_has_one_answer_in_fresh_processes(tmp_path):
    want = port_results()
    for i in range(1, 3):
        np.testing.assert_array_equal(want[f"fir{i}"], want["fir0"])
    np.testing.assert_array_equal(want["render1"], want["render0"])
    here = Path(__file__).resolve()
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(here.parent.parent),
                                          str(here.parent)])}
    outs = [tmp_path / f"p{i}.npz" for i in range(PROCESSES)]
    for lo in range(0, PROCESSES, AT_ONCE):
        procs = [subprocess.Popen([sys.executable, str(here), str(o)],
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for o in outs[lo:lo + AT_ONCE]]
        for p in procs:
            try:
                log, _ = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail(f"a render process ran past {TIMEOUT_S} s")
            assert p.returncode == 0, log
    for o in outs:
        with np.load(o) as got:
            assert int(got["threads"]) == 1
            for key, value in want.items():
                np.testing.assert_array_equal(got[key], value, err_msg=key)


if __name__ == "__main__":
    main(sys.argv[1])
