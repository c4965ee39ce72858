"""PyTorch/CUDA port, the multi-device layer (``parallel/``) on the CPU:
real multi-process ``torch.distributed`` jobs over gloo, one per mesh shape,
each computing every case of its shape in ``torch_dist_worker.py`` (a
module-scoped fixture starts them all at once, one torch thread a process,
and reads their .npz). At the JAX tests' size (``tests/test_parallel.py``):
chain8, 8 channels x 16 blocks of 512.

Each case is held to the port's single-device render and to the JAX
package's ``ShardedRenderer`` (or its dynspec / timescan) on the same mesh
shape over the virtual 8-device CPU mesh that ``tests/conftest.py``
provides. Bars: >= 100 dB to the port's single device for chains without a
dynamics stage (the JAX bar, ``tests/test_parallel.py:46``); >= 90 dB for
chain8, the port's bar where the conv's last bits move (shards with a halo
put the overlap-save windows elsewhere); >= 90 dB to the JAX renderer;
dynspec bit-equal to the port's single-device stage; timescan >= 130 dB to
the port's single-device float64 recurrence and >= 60 dB to JAX's (its own
bar, ``tests/test_timescan.py:36``).

The same jobs play the rank program that the card captures
(``parallel/captured.py``) piece by piece, with dynspec's rounds on the
device (the NCCL route) and read back each round (gloo's): bit-equal to
``render_shard``, chain8 >= 90 dB to the JAX package's renderer, dynspec
bit-equal to the host-read rounds with the same round count and >= 90 dB to
JAX's dynspec, the exchanges made equal to the planned cuts, and no host
read but the params' and the flags'."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyaudiodsptools_tpu as jx
import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu.core import block as jx_block
from pyaudiodsptools_tpu.ops.eq3band import eq_band as jx_eq_band
from pyaudiodsptools_tpu.parallel import ShardedRenderer as JxRenderer
from pyaudiodsptools_tpu.parallel import make_mesh as jx_make_mesh
from pyaudiodsptools_tpu.parallel.dynspec import \
    dynamics_offline_time_sharded as jx_dynspec
from pyaudiodsptools_tpu.parallel.timescan import \
    eq3band_offline_sharded as jx_timescan
from pyaudiodsptools_tpu_torch.core import block as pt_block
from pyaudiodsptools_tpu_torch.kernels import dynamics as pt_dynamics
from pyaudiodsptools_tpu_torch.ops.eq3band import offline as eq_recurrence
from pyaudiodsptools_tpu_torch.ops.tremolo import gain_row
from pyaudiodsptools_tpu_torch.parallel import (Mesh, ShardedRenderer,
                                                make_mesh, single_device_mesh)
from pyaudiodsptools_tpu_torch.parallel.dynspec import is_dynamics_params
from pyaudiodsptools_tpu_torch.parallel.sharding import plan_cuts

import torch_dist_worker as worker
from torch_port_util import snr_db

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [(2, 1), (1, 2), (2, 2), (1, 4)]
TIMEOUT_S = 300
B = worker.B
CPU = "cpu"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Mesh shape -> (global results, [each rank's local results]) or the
    failing job's logs. All four jobs run at once (12 processes)."""
    jobs = {}
    for c, t in SHAPES:
        out = tmp_path_factory.mktemp(f"mesh{c}x{t}")
        port, world = _free_port(), c * t
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).with_name(
                "torch_dist_worker.py")), str(r), str(world), str(port),
             str(c), str(t), str(out)],
            cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(ROOT),
                                "OMP_NUM_THREADS": "1"},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        jobs[(c, t)] = (out, procs)
    deadline = time.monotonic() + TIMEOUT_S
    results = {}
    for shape, (out, procs) in jobs.items():
        logs, ok = [], True
        for p in procs:
            try:
                log, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                log, _ = p.communicate()
                log += f"\n(killed after {TIMEOUT_S} s)"
            logs.append(log)
            ok = ok and p.returncode == 0
        if not ok:
            results[shape] = "\n".join(logs)
            continue
        with np.load(out / "global.npz") as g:
            glob = dict(g)
        local = []
        for r in range(len(procs)):
            path = out / f"local_{r}.npz"
            if path.exists():
                with np.load(path) as f:
                    local.append(f["local"])
        results[shape] = (glob, local)
    return results


def _job(runs, shape):
    got = runs[shape]
    if isinstance(got, str):
        pytest.fail(f"the {shape} job failed:\n{got}")
    return got


@pytest.fixture(scope="module")
def data():
    return worker.inputs()


@pytest.fixture(scope="module")
def port_single(data):
    """The port's single-device renders and stages on the CPU."""
    cfg = pt.EngineConfig(44100, B)
    out = {}
    chain8 = pt.Chain(worker.chain8_effects(pt, cfg, device=CPU), device=CPU)
    out["chain8"] = pt.render(chain8, data["chain8"], cfg).numpy()
    cascade = chain8.exec_effects[1]
    comp = pt.ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1, device=CPU)
    blocks = pt_block.make_blocks(torch.from_numpy(data["dyn"]), B)
    out["dyn_cascade"] = pt_block.combine_blocks(
        cascade.offline(cascade.params, blocks)).numpy()
    out["dyn_comp"] = pt_block.combine_blocks(
        comp.offline(comp.params, blocks)).numpy()
    eq_chain = pt.Chain(worker.eq_effects(pt, cfg, device=CPU), device=CPU)
    out["eq_chain"] = pt.render(eq_chain, data["eq"], cfg).numpy()
    eq_blocks = pt_block.make_blocks(torch.from_numpy(data["eq"]), B)
    low_shelf = eq_chain.exec_effects[1]
    out["eq_low"] = pt_block.combine_blocks(
        eq_recurrence(low_shelf.params, eq_blocks)).numpy()
    out["eq_alone"] = pt_block.combine_blocks(eq_recurrence(
        worker.eq3band_setting(pt, cfg, device=CPU).params,
        eq_blocks)).numpy()
    out["eq_low_float64"] = recursion64(low_shelf.params.coeffs.numpy(),
                                        data["eq"])
    low = pt.Chain([pt.ops.lowcut(cfg, 400.0, device=CPU)], device=CPU)
    out["lowcut"] = pt.render(low, data["lowcut"], cfg).numpy()
    return out


def recursion64(rows, x: np.ndarray) -> np.ndarray:
    """The reference's per-sample direct form I in float64, each band fed
    the previous band's output, with the one-sample input delay."""
    y = x.astype(np.float64)
    for b0, b1, b2, a1, a2 in rows:
        out = np.zeros_like(y)
        for c in range(y.shape[0]):
            x1 = x2 = x3 = y1 = y2 = 0.0
            for n, v in enumerate(y[c].tolist()):
                o = b0 * x1 + b1 * x2 + b2 * x3 - a1 * y1 - a2 * y2
                x3, x2, x1 = x2, x1, v
                y2, y1 = y1, o
                out[c, n] = o
        y = out
    return y


_JAX_RENDERS = {}


def _jax_sharded(effects_fn, sig, shape):
    if len(jax.devices()) < shape[0] * shape[1]:
        pytest.skip("needs the virtual 8-device mesh")
    key = (effects_fn, sig.tobytes(), shape)    # each is compiled once
    if key not in _JAX_RENDERS:
        cfg = jx.EngineConfig(44100, B)
        chain = jx.Chain(effects_fn(jx, cfg))
        mesh = jx_make_mesh(channel=shape[0], time=shape[1])
        _JAX_RENDERS[key] = np.asarray(
            JxRenderer(chain, cfg, mesh).render(sig))
    return _JAX_RENDERS[key]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_chain8_sharded_render(runs, data, port_single, shape):
    glob, _ = _job(runs, shape)
    got = glob["chain8"]
    want = port_single["chain8"]
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert snr_db(want, got) >= 90.0
    jgot = _jax_sharded(worker.chain8_effects, data["chain8"], shape)
    assert snr_db(jgot, got) >= 90.0


def test_channel_mesh_keeps_every_channel_as_one_render(runs, port_single):
    """(2, 1): no halo and no exchange but the final gather; each channel
    shard runs the very chain a one-device render runs on its channels."""
    glob, _ = _job(runs, (2, 1))
    cfg = pt.EngineConfig(44100, B)
    chain8 = pt.Chain(worker.chain8_effects(pt, cfg, device=CPU), device=CPU)
    x = worker.inputs()["chain8"]
    halves = [pt.render(chain8, x[:4], cfg).numpy(),
              pt.render(chain8, x[4:], cfg).numpy()]
    np.testing.assert_array_equal(glob["chain8"], np.concatenate(halves))


def test_lowcut_halo_longer_than_a_shard(runs, data, port_single):
    """A lowcut reaches back 639 samples; at (1, 4) over 4 blocks each
    shard is one block of 512, so its halo comes from two ranks."""
    cfg = pt.EngineConfig(44100, B)
    assert pt.ops.lowcut(cfg, 400.0, device=CPU).reach == 639
    glob, _ = _job(runs, (1, 4))
    got = glob["lowcut"]
    assert snr_db(port_single["lowcut"], got) >= 100.0
    jgot = _jax_sharded(lambda pkg, c: [pkg.ops.lowcut(c, 400.0)],
                        data["lowcut"], (1, 4))
    assert snr_db(jgot, got) >= 90.0


@pytest.mark.parametrize("time_", [2, 4])
@pytest.mark.parametrize("case", ["dyn_cascade", "dyn_comp"])
def test_dynspec_equals_the_single_device_stage(runs, data, port_single,
                                                time_, case):
    glob, _ = _job(runs, (1, time_))
    np.testing.assert_array_equal(glob[case], port_single[case])
    # and the JAX package's dynspec on the same mesh shape
    if len(jax.devices()) < time_:
        pytest.skip("needs the virtual 8-device mesh")
    cfg = jx.EngineConfig(44100, B)
    comp = jx.ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1)
    gate = jx.ops.gate(cfg, -45.0, 0.1, 3.1, 200.1)
    mesh = jx_make_mesh(channel=1, time=time_)
    blocks = jx_block.make_blocks(jnp.asarray(data["dyn"]), B)
    for eff in ((comp, gate) if case == "dyn_cascade" else (comp,)):
        blocks = jax.jit(lambda p, b: jx_dynspec(p, b, mesh))(eff.params,
                                                              blocks)
    want = np.asarray(jx_block.combine_blocks(blocks))
    assert snr_db(want, glob[case]) >= 90.0


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_timescan_equals_the_float64_recurrence(runs, port_single, shape):
    """The JAX tests' 3-band EQ through timescan: >= 130 dB to the port's
    single-device float64 recurrence. The undecayed low shelf at 0.3 Hz
    (what the renderer routes to timescan) is ill-conditioned for the
    chunked float64 recurrence itself: the single-device one sits 128 dB
    from a per-sample float64 recursion (which is 211 dB from a long-double
    one), so there timescan is held to both at 120 dB; and the chain around
    it through the renderer to the single-device render at 100 dB."""
    glob, _ = _job(runs, shape)
    assert snr_db(port_single["eq_alone"], glob["eq_alone"]) >= 130.0
    assert snr_db(port_single["eq_low"], glob["eq_low"]) >= 120.0
    assert snr_db(port_single["eq_low_float64"], glob["eq_low"]) >= 120.0
    assert snr_db(port_single["eq_chain"], glob["eq_chain"]) >= 100.0


def test_timescan_against_jax(runs, data):
    """The JAX package's own timescan (float32 pairs) at (1, 2), on the low
    shelf of its own test setting (one band: its scan compiles per band;
    the undecayed shelf at 0.3 Hz is beyond its float32 blocked scan)."""
    glob, _ = _job(runs, (1, 2))
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual 8-device mesh")
    eff = jx_eq_band(jx.EngineConfig(44100, B), "low", 200.0, 3.0)
    blocks = jx_block.make_blocks(jnp.asarray(data["eq"]), B)
    jgot = np.asarray(jx_block.combine_blocks(jx_timescan(
        eff.params, blocks, jx_make_mesh(channel=1, time=2))))
    assert snr_db(jgot, glob["eq_shelf"]) >= 60.0


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_render_local_channels_and_meters(runs, port_single, shape):
    glob, local = _job(runs, shape)
    assert len(local) == 2 and all(p.shape == (4, B * 16) for p in local)
    got = np.concatenate(local)
    # each rank's channels of the very render the global path gathers
    np.testing.assert_array_equal(got, glob["chain8"])
    assert snr_db(port_single["chain8"], got) >= 90.0
    peak, rms = glob["meters"]
    ref = glob["chain8"].astype(np.float64)
    assert peak == np.abs(ref).max()
    np.testing.assert_allclose(rms, np.sqrt(np.mean(ref ** 2)), rtol=1e-12)


def test_one_rank_meshes_need_no_process_group():
    """Without torch.distributed: a 1x1 mesh and single_device_mesh have no
    group, and the renderer makes the calls of Chain.render_blocks."""
    assert not torch.distributed.is_initialized()
    cfg = pt.EngineConfig(44100, B)
    chain8 = pt.Chain(worker.chain8_effects(pt, cfg, device=CPU), device=CPU)
    x = worker.noise(2, 6 * B - 50, 7)
    want = pt.render(chain8, x, cfg).numpy()
    for mesh in (make_mesh(1, 1, device=CPU), make_mesh(device=CPU),
                 single_device_mesh(CPU)):
        assert isinstance(mesh, Mesh) and mesh.coords == (0, 0)
        assert mesh.group is None and mesh.groups == {"channel": None,
                                                      "time": None}
        got = ShardedRenderer(chain8, cfg, mesh).render(x).numpy()
        np.testing.assert_array_equal(got, want)


def test_mesh_and_renderer_refuse_what_jax_refuses():
    cfg = pt.EngineConfig(44100, B)
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        make_mesh(channel=2, time=1, device=CPU)
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        make_mesh(channel=1, time=2, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(1, 1)               # the card unless asked for the CPU
    chain = pt.Chain([pt.ops.softclipper(cfg, device=CPU)], device=CPU)
    r = ShardedRenderer(chain, cfg, single_device_mesh(CPU))
    with pytest.raises(ValueError, match="channels, n"):
        r.render(np.zeros(B, np.float32))


def test_routing_marks():
    """What the renderer routes by: reach, block_indexed and the recurrent
    stages, on the port's effects."""
    cfg = pt.EngineConfig(44100, B)
    chain8 = pt.Chain(worker.chain8_effects(pt, cfg, device=CPU), device=CPU)
    fir, dyn, tail = chain8.exec_effects
    assert fir.time_parallel and fir.reach == len(fir.lti_kernel) - 1
    assert not fir.block_indexed
    assert is_dynamics_params(dyn.params) and not dyn.time_parallel
    assert tail.time_parallel and tail.block_indexed
    assert tail.reach == 2 * int(150.0 * 44.1)          # two taps, 150 ms
    assert pt.ops.tremolo(cfg, device=CPU).block_indexed
    assert pt.ops.delay(cfg, 150.0, 2, device=CPU).reach == 13230


def test_tremolo_rows_of_a_shard_continue_the_render():
    """A shard's tremolo gains from its first global block equal that slice
    of the whole render's row (the freeze quirk included)."""
    cfg = pt.EngineConfig(44100, B)
    p = pt.ops.tremolo(cfg, 0.3, 5.0, device=CPU).params
    row = gain_row(p, 40, B)
    for first, nb in ((0, 7), (13, 9), (31, 9)):
        np.testing.assert_array_equal(
            gain_row(p, nb, B, first_block=first).numpy(),
            row[first * B:(first + nb) * B].numpy())


def test_dynamics_stage_is_the_serial_walk(data):
    """dynspec's sweep primitive, the serial walk from REST over a whole
    signal, equals the speculative stage bit for bit (the premise of its
    exactness)."""
    cfg = pt.EngineConfig(44100, B)
    comp = pt.ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1, device=CPU)
    x = torch.from_numpy(data["dyn"])
    sc = [pt_dynamics.op_scalars(comp.params)]
    out, _ = pt_dynamics.serial_walk(sc, x, torch.zeros((1, 2), dtype=torch.int32))
    np.testing.assert_array_equal(
        out.numpy(), pt_dynamics.dynamics_offline(comp.params, x).numpy())


# ---------------------------------------------------------------------------
# the rank program that the card captures (``parallel/captured.py``), played
# piece by piece in the same jobs: ``prog<k>_*`` with dynspec's rounds on
# the device (k = 1, the NCCL route) or read back each round (k = 0, gloo's)


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rank_program_played_piece_by_piece_equals_render_shard(
        runs, data, port_single, shape, k):
    """Bit-equal to ``render_shard`` + ``gather`` (the eager renders of the
    same job), chain8 >= 90 dB to the JAX package's ``ShardedRenderer`` and
    the undecayed-EQ chain >= 100 dB to the port's single device (the JAX
    package's own float32 scan of that shelf is 85 dB from both, single
    device included), with the same dynspec rounds both ways."""
    glob, _ = _job(runs, shape)
    np.testing.assert_array_equal(glob[f"prog{k}_chain8"], glob["chain8"])
    np.testing.assert_array_equal(glob[f"rounds{k}_chain8"],
                                  glob["rounds0_chain8"])
    assert len(glob["rounds0_chain8"]) == (shape[1] > 1)
    assert snr_db(port_single["eq_chain"], glob[f"prog{k}_eq_chain"]) >= 100.0
    if shape[1] > 1:
        np.testing.assert_array_equal(glob[f"prog{k}_eq_chain"],
                                      glob["eq_chain"])
    if shape == (1, 4):
        np.testing.assert_array_equal(glob[f"prog{k}_lowcut"],
                                      glob["lowcut"])
    jgot = _jax_sharded(worker.chain8_effects, data["chain8"], shape)
    assert snr_db(jgot, glob[f"prog{k}_chain8"]) >= 90.0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_program_exchanges_are_the_planned_cuts(runs, shape):
    """Under gloo (k = 0) every exchange the program made is a planned cut,
    in order; with dynspec's rounds on the device (k = 1) the program made
    the same exchanges but dynspec's, which its rounds make inside."""
    glob, _ = _job(runs, shape)
    cfg = pt.EngineConfig(44100, B)
    chains = {"chain8": worker.chain8_effects, "eq_chain": worker.eq_effects,
              "lowcut": lambda pkg, c, **kw: [pkg.ops.lowcut(c, 400.0, **kw)]}
    for name, effects in chains.items():
        if f"exchanges0_{name}" not in glob:
            continue
        chain = pt.Chain(effects(pt, cfg, device=CPU), device=CPU)
        mesh_shape = {"channel": shape[0], "time": shape[1]}
        plan = plan_cuts(chain, mesh_shape, B, capturable=False)
        assert list(glob[f"exchanges0_{name}"]) == plan
        assert list(glob[f"exchanges1_{name}"]) == [
            cut for cut in plan if cut != "dynspec rounds"]
        assert plan_cuts(chain, mesh_shape, B, capturable=True) == []


@pytest.mark.parametrize("signal", ["dyn", "dyn_silence"])
@pytest.mark.parametrize("time_", [2, 4])
@pytest.mark.parametrize("case", ["cascade", "comp"])
def test_device_rounds_equal_the_host_rounds(runs, data, time_, case, signal):
    """dynspec's rounds on the device (``time`` rounds unrolled, each walk
    where the round is live, the round step's plain version here) bit-equal
    to the rounds that read their flag back, with the same round count, and
    to the single-device stage; >= 90 dB to the JAX package's dynspec (its
    ramps are float32 ``linspace`` tables, the port's arithmetic: within 2
    ulp); on the burst signal and on a burst followed by silence, whose gate
    release crosses every shard. The loop never runs more than ``time``
    rounds (its bound is time + 1), which is why ``time`` unrolled rounds
    give its bits."""
    glob, _ = _job(runs, (1, time_))
    got = glob[f"dynspec1_{case}_{signal}"]
    np.testing.assert_array_equal(got, glob[f"dynspec0_{case}_{signal}"])
    rounds = glob[f"rounds1_{case}_{signal}"]
    np.testing.assert_array_equal(rounds, glob[f"rounds0_{case}_{signal}"])
    assert len(rounds) == 1 and 1 <= rounds[0] <= time_
    cfg = pt.EngineConfig(44100, B)
    comp = pt.ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1, device=CPU)
    ops = [comp]
    if case == "cascade":
        ops.append(pt.ops.gate(cfg, -45.0, 0.1, 3.1, 200.1, device=CPU))
    single = pt_dynamics.dynamics_offline(
        tuple(e.params for e in ops) if case == "cascade" else comp.params,
        torch.from_numpy(data[signal]))
    np.testing.assert_array_equal(got, single.numpy())
    if len(jax.devices()) < time_:
        pytest.skip("needs the virtual 8-device mesh")
    jcfg = jx.EngineConfig(44100, B)
    jops = [jx.ops.compressor(jcfg, -18.0, 0.6, 3.1, 30.1)]
    if case == "cascade":
        jops.append(jx.ops.gate(jcfg, -45.0, 0.1, 3.1, 200.1))
    mesh = jx_make_mesh(channel=1, time=time_)
    blocks = jx_block.make_blocks(jnp.asarray(data[signal]), B)
    for eff in jops:
        blocks = jax.jit(lambda p, b: jx_dynspec(p, b, mesh))(eff.params,
                                                              blocks)
    want = np.asarray(jx_block.combine_blocks(blocks))
    assert snr_db(want, got) >= 90.0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_capturable_program_reads_back_only_its_flags(runs, shape):
    """chain8's program with dynspec's rounds on the device, under a guard
    that refuses a host read of any tensor but the params' and the flags':
    nothing else is read (a graph would freeze it). Played eagerly, the
    rounds read their flags once a round, whether to walk (time > 1), and
    the time == 1 fixpoint its settle flags once a walk; a capture turns
    each read into a conditional node's condition, set on the card."""
    glob, _ = _job(runs, shape)
    assert str(glob["guard_error"]) == ""
    settles, rounds = glob["guard_flags"]
    if shape[1] > 1:
        assert (settles, rounds) == (0, 1)
        assert glob["guard_flag_reads"] == shape[1]
    else:
        assert (settles, rounds) == (1, 0)
        assert glob["guard_flag_reads"] >= 1
