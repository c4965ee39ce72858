"""PyTorch/CUDA port, the slices as a whole: the flagship 8-effect chain
(chain8) and its earlier stand-in chain7 (saturator in place of the
compressor/gate pair) through ``Chain`` and ``render`` against the JAX
package's ``Chain`` on the CPU, the conversion layer against the port's own
factories, and the import rule."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyaudiodsptools_tpu as jx
import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu.core import block as jx_block
from pyaudiodsptools_tpu_torch import convert
from pyaudiodsptools_tpu_torch.kernels import (dynamics as pt_dynamics,
                                               relayout as pt_relayout,
                                               segconv, tail as pt_tail)

from torch_port_util import snr_db, spec_from_jax

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIR_NAME = "fir_cascade:lowcut+highcut+eq3band_fft"
TAIL_NAME = "tail:saturator+delay+tremolo+softclipper"
DYN_NAME = "dynamics_cascade:compressor+gate"
TAIL8_NAME = "tail:delay+tremolo+softclipper"


def _chain7_effects(pkg, cfg, **kw):
    o = pkg.ops
    return [o.lowcut(cfg, 120.0, **kw), o.highcut(cfg, 12000.0, **kw),
            o.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5, **kw),
            o.saturator(cfg, **kw),          # stands where compressor -> gate
            o.delay(cfg, 150.0, 2, **kw),    # stand in the 8-effect chain
            o.tremolo(cfg, 0.3, 5.0, **kw), o.softclipper(cfg, 0.44, **kw)]


def _chain8_effects(pkg, cfg, **kw):
    """The flagship chain, with the arguments of ``__graft_entry__._chain8``."""
    o = pkg.ops
    return [o.lowcut(cfg, 120.0, **kw), o.highcut(cfg, 12000.0, **kw),
            o.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5, **kw),
            o.compressor(cfg, -18.0, 0.6, 3.1, 30.1, **kw),
            o.gate(cfg, -45.0, 0.1, 3.1, 200.1, **kw),
            o.delay(cfg, 150.0, 2, **kw),
            o.tremolo(cfg, 0.3, 5.0, **kw), o.softclipper(cfg, 0.44, **kw)]


def _signal(C, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, n)) * 0.25
    t = np.arange(n)
    burst = (np.sin(2 * np.pi * t / (44100 // 3)) > 0.6) * 0.5 + 0.3
    return np.clip(x * burst, -0.99, 0.99).astype(np.float32)


@pytest.mark.parametrize("B", [512, 4096])
def test_chain7_render_matches_jax(B):
    pcfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_chain7_effects(pt, pcfg, device=CPU), device=CPU)
    # the structure the JAX Chain has on the TPU (on the CPU it leaves the
    # tail unfused; the port fuses on every device)
    assert [e.name for e in chain.exec_effects] == [FIR_NAME, TAIL_NAME]
    n = 40 * B - 100                       # about 40 blocks, ragged
    x = _signal(3, n, seed=B)
    got = pt.render(chain, x, pcfg).numpy()
    assert got.shape == (3, 40 * B) and got.dtype == np.float32
    trimmed = pt.render(chain, x, pcfg, trim=True).numpy()
    assert trimmed.shape == (3, n)
    np.testing.assert_array_equal(trimmed, got[:, :n])

    jcfg = jx.EngineConfig(44100, B)
    jchain = jx.Chain(_chain7_effects(jx, jcfg))
    assert jchain.exec_effects[0].name == FIR_NAME
    blocks = jx_block.make_blocks(jnp.asarray(x), B)
    want = np.asarray(jx_block.combine_blocks(jchain.render_blocks(blocks)))
    # the bar of the JAX package's own kernel-backed chain test on the chip
    assert snr_db(want, got) >= 90.0
    # use_kernels=False is the same computation on a CPU tensor
    np.testing.assert_array_equal(
        pt.render(chain, x, pcfg, use_kernels=False).numpy(), got)


@pytest.mark.parametrize("build", ["factories", "converted"])
@pytest.mark.parametrize("B", [512, 4096])
def test_chain8_render_matches_jax(B, build):
    """The real 8-effect chain, built by the port's own factories and through
    the conversion layer from the JAX effects' numpy params. The JAX Chain on
    the CPU runs its faithful path (scans for the dynamics pair, no kernel
    routing); the bar is the JAX package's own for its kernel-backed chain
    against that path, 90 dB. What separates the two: the conv's fp32
    rounding, and the walks' arithmetic ramps (<= 2 ulp off the tables)."""
    pcfg = pt.EngineConfig(44100, B)
    jeffects = _chain8_effects(jx, jx.EngineConfig(44100, B))
    if build == "factories":
        chain = pt.Chain(_chain8_effects(pt, pcfg, device=CPU), device=CPU)
    else:
        chain = convert.chain_from_numpy(spec_from_jax(jeffects), device=CPU)
    assert [e.name for e in chain.exec_effects] == \
        [FIR_NAME, DYN_NAME, TAIL8_NAME]
    n = 24576 - 100          # 6 blocks of 4096 or 48 of 512, the last ragged
    x = _signal(2, n, seed=B + 8)
    got = pt.render(chain, x, pcfg).numpy()
    assert got.shape == (2, 24576) and got.dtype == np.float32

    blocks = jx_block.make_blocks(jnp.asarray(x), B)
    want = np.asarray(jx_block.combine_blocks(
        jx.Chain(jeffects).render_blocks(blocks)))
    assert snr_db(want, got) >= 90.0
    np.testing.assert_array_equal(
        pt.render(chain, x, pcfg, use_kernels=False).numpy(), got)


@pytest.mark.parametrize("delay_args", [(1000.0, 2), (10.0, 65)],
                         ids=["1000ms_x2", "10ms_x65"])
def test_long_tail_runs_build_and_match_jax(delay_args):
    """Tail runs the JAX package fuses and renders, which the port's fused
    tail once refused when the Chain was built: a halo of 88,200 samples
    (rings in device memory on the card), and 65 taps (halo 28,665)."""
    B = 512
    pcfg, jcfg = pt.EngineConfig(44100, B), jx.EngineConfig(44100, B)

    def effects(pkg, cfg, **kw):
        o = pkg.ops
        return [o.delay(cfg, *delay_args, **kw), o.tremolo(cfg, 0.3, 5.0, **kw),
                o.softclipper(cfg, 0.44, **kw)]

    chain = pt.Chain(effects(pt, pcfg, device=CPU), device=CPU)
    assert [e.name for e in chain.exec_effects] == \
        ["tail:delay+tremolo+softclipper"]
    n = 200 * B - 100                  # past the second echo of 1,000 ms
    x = _signal(2, n, seed=int(delay_args[1]))
    got = pt.render(chain, x, pcfg).numpy()
    blocks = jx_block.make_blocks(jnp.asarray(x), B)
    want = np.asarray(jx_block.combine_blocks(
        jx.Chain(effects(jx, jcfg)).render_blocks(blocks)))
    assert got.shape == want.shape
    # the bar of the tail's own parity test: pow differs by ulps
    assert snr_db(want, got) >= 100.0


def _leaves(params):
    """Flatten a params object to comparable (path, value) pairs."""
    out = []
    if isinstance(params, tuple):
        for i, p in enumerate(params):
            out += [((i,) + k, v) for k, v in _leaves(p)]
    elif dataclasses.is_dataclass(params):
        for f in dataclasses.fields(params):
            out += [((f.name,) + k, v)
                    for k, v in _leaves(getattr(params, f.name))]
    else:
        out.append(((), params))
    return out


@pytest.mark.parametrize("B", [512, 4096])
def test_conversion_gives_the_factories_params_exactly(B):
    jeffects = _chain7_effects(jx, jx.EngineConfig(44100, B))
    converted = convert.chain_from_numpy(spec_from_jax(jeffects), device=CPU)
    own = pt.Chain(_chain7_effects(pt, pt.EngineConfig(44100, B), device=CPU),
                   device=CPU)
    assert [e.name for e in converted.exec_effects] == \
        [e.name for e in own.exec_effects] == [FIR_NAME, TAIL_NAME]
    _assert_same_chain(converted, own, B)


@pytest.mark.parametrize("B", [512, 4096])
def test_conversion_gives_the_factories_params_exactly_chain8(B):
    jeffects = _chain8_effects(jx, jx.EngineConfig(44100, B))
    converted = convert.chain_from_numpy(spec_from_jax(jeffects), device=CPU)
    own = pt.Chain(_chain8_effects(pt, pt.EngineConfig(44100, B), device=CPU),
                   device=CPU)
    assert [e.name for e in converted.exec_effects] == \
        [e.name for e in own.exec_effects] == [FIR_NAME, DYN_NAME, TAIL8_NAME]
    _assert_same_chain(converted, own, B)


def _assert_same_chain(converted, own, B):
    a, b = _leaves(converted.params), _leaves(own.params)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (key, va), (_, vb) in zip(a, b):
        if isinstance(va, torch.Tensor):
            assert va.dtype == vb.dtype and va.device == vb.device, key
            assert torch.equal(va, vb), key
        else:
            assert va == vb, key
    for ec, eo in zip(converted.effects, own.effects):
        if eo.lti_kernel is not None:
            np.testing.assert_array_equal(ec.lti_kernel, eo.lti_kernel)
    x = _signal(2, 12 * B, seed=1)
    cfg = pt.EngineConfig(44100, B)
    assert torch.equal(pt.render(converted, x, cfg), pt.render(own, x, cfg))


def test_conversion_refuses_what_is_not_ported():
    # every effect of the JAX package is ported since the reverb's slice:
    # what is refused is a name no package has
    with pytest.raises(ValueError, match="not part of the port"):
        convert.effect_from_numpy({"op": "chorus"}, device=CPU)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = pt.EngineConfig(44100, 512)
    with pytest.raises(RuntimeError, match="cuda"):
        pt.Chain([], device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        pt.ops.lowcut(cfg, 120.0)              # the default device is cuda
    with pytest.raises(RuntimeError, match="cuda"):
        pt.ops.softclipper(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        convert.chain_from_numpy([], device="cuda")


def test_chain_step_raises_with_a_fir_and_runs_a_tail():
    cfg = pt.EngineConfig(44100, 512)
    chain = pt.Chain(_chain7_effects(pt, cfg, device=CPU), device=CPU)
    # with the streaming slice a chain that holds a FIR steps too, and folds
    # to its offline render (another window, the same convolution)
    x = torch.from_numpy(_signal(2, 12 * 512, 5))
    state = chain.init_state((2,))
    assert state[0]["hist"].shape == (2, 1155 + 2048 - 512)
    outs = []
    for i in range(12):
        state, y = chain.step(state, x[:, i * 512:(i + 1) * 512])
        outs.append(y)
    assert snr_db(pt.render(chain, x, cfg).numpy(),
                  torch.cat(outs, dim=-1).numpy()) >= 110.0
    tail = pt.Chain(_chain7_effects(pt, cfg, device=CPU)[3:], device=CPU)
    assert [e.name for e in tail.exec_effects] == [TAIL_NAME]
    blocks = pt.block.make_blocks(torch.from_numpy(_signal(2, 30 * 512, 3)), 512)
    state = tail.init_state((2,))
    outs = []
    for i in range(blocks.shape[-2]):
        state, y = tail.step(state, blocks[:, i])
        outs.append(y)
    assert snr_db(tail.render_blocks(blocks).numpy(),
                  torch.stack(outs, dim=-2).numpy()) >= 120.0


def test_fusion_structure():
    cfg = pt.EngineConfig(44100, 512)
    o = pt.ops
    names = lambda effs, **kw: [e.name for e in
                                pt.Chain(effs, device=CPU, **kw).exec_effects]
    # unfused on request
    assert len(names(_chain7_effects(pt, cfg, device=CPU), fuse=False)) == 7
    # a short delay next to filters joins the FIR cascade ...
    assert names([o.lowcut(cfg, 120.0, device=CPU),
                  o.delay(cfg, 10.0, 2, device=CPU)]) == \
        ["fir_cascade:lowcut+delay"]
    # ... and so does one of 150 ms, whose fused FIR (13,739 stripped taps)
    # still streams at B=512 (a window of 16,384) ...
    assert names([o.lowcut(cfg, 120.0, device=CPU),
                  o.highcut(cfg, 9000.0, device=CPU),
                  o.delay(cfg, 150.0, 2, device=CPU),
                  o.softclipper(cfg, device=CPU)]) == \
        ["fir_cascade:lowcut+highcut+delay", "softclipper"]
    # ... and so does a long one, as in the JAX Chain, though its fused FIR
    # outgrows the largest streaming window (65,536): it streams in
    # partitions
    assert names([o.lowcut(cfg, 120.0, device=CPU),
                  o.highcut(cfg, 9000.0, device=CPU),
                  o.delay(cfg, 1000.0, 2, device=CPU),
                  o.softclipper(cfg, device=CPU)]) == \
        ["fir_cascade:lowcut+highcut+delay", "softclipper"]
    # the flagship chain: three fused stages
    assert names(_chain8_effects(pt, cfg, device=CPU)) == \
        [FIR_NAME, DYN_NAME, TAIL8_NAME]
    assert len(names(_chain8_effects(pt, cfg, device=CPU), fuse=False)) == 8
    # a lone compressor stays a compressor (its own offline takes the walks);
    # a run longer than one kernel walks is cut into consecutive cascades
    comp = lambda: o.compressor(cfg, -18.0, 0.6, device=CPU)
    gate = lambda: o.gate(cfg, -45.0, 0.1, device=CPU)
    assert names([o.lowcut(cfg, 120.0, device=CPU), comp(),
                  o.softclipper(cfg, device=CPU)]) == \
        ["lowcut", "compressor", "softclipper"]
    assert names([gate(), comp()]) == ["dynamics_cascade:gate+compressor"]
    assert pt_dynamics.MAX_OPS == 4
    assert names([comp(), gate(), comp(), gate(), comp(), gate()]) == \
        ["dynamics_cascade:compressor+gate+compressor+gate",
         "dynamics_cascade:compressor+gate"]
    assert names([comp(), gate(), comp(), gate(), comp()]) == \
        ["dynamics_cascade:compressor+gate+compressor+gate", "compressor"]
    # a lone tail member stays as it is; a scan-only effect still renders
    lone = pt.Chain([o.tremolo(cfg, device=CPU)], device=CPU)
    assert names([o.tremolo(cfg, device=CPU)]) == ["tremolo"]
    e = lone.exec_effects[0]._replace(offline=None)
    x = torch.from_numpy(_signal(2, 6 * 512, 5)).reshape(2, 6, 512)
    from pyaudiodsptools_tpu_torch.engine.chain import chain_render
    assert snr_db(lone.render_blocks(x).numpy(),
                  chain_render((e,), (e.params,), x).numpy()) >= 120.0


def test_chain_refuses_mixed_devices():
    cfg = pt.EngineConfig(44100, 512)
    chain = pt.Chain([pt.ops.softclipper(cfg, device=CPU)], device=CPU)
    fake = chain.effects[0]._replace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="built for device"):
        pt.Chain([fake], device=CPU)


def _launch_counts():
    return (segconv.launch_count, pt_tail.launch_count,
            pt_relayout.pack_launch_count, pt_relayout.unpack_launch_count,
            pt_dynamics.state_walk_launch_count,
            pt_dynamics.audio_walk_launch_count)


def test_cpu_render_launches_no_kernel():
    before = _launch_counts()
    cfg = pt.EngineConfig(44100, 512)
    for effects in (_chain7_effects, _chain8_effects):
        chain = pt.Chain(effects(pt, cfg, device=CPU), device=CPU)
        pt.render(chain, _signal(1, 4096, 0), cfg)
    assert _launch_counts() == before


def test_cut_cascades_render_what_the_members_render_in_sequence():
    """Six dynamics effects fuse into a cascade of four and one of two; the
    result is that of the six run one by one."""
    cfg = pt.EngineConfig(44100, 512)
    o = pt.ops
    effs = [o.compressor(cfg, -18.0, 0.6, device=CPU),
            o.gate(cfg, -45.0, 0.1, 3.1, 20.0, device=CPU)] * 3
    x = _signal(2, 8 * 512, seed=4)
    fused = pt.render(pt.Chain(effs, device=CPU), x, cfg)
    apart = pt.render(pt.Chain(effs, device=CPU, fuse=False), x, cfg)
    assert torch.equal(fused, apart)


def test_render_file_roundtrip(tmp_path):
    cfg = pt.EngineConfig(44100, 512)
    x = _signal(2, 3000, seed=9)
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    pt.wavio.write_wav(src, x, 44100)
    chain = pt.Chain([pt.ops.softclipper(cfg, device=CPU)], device=CPU)
    out = pt.render_file(chain, src, dst, cfg, trim=True)
    back, rate = pt.wavio.read_wav(dst)
    assert rate == 44100 and back.shape == out.shape == (2, 3000)
    # written as trunc(x * 32767), read back as / 32768: under two steps
    assert np.max(np.abs(back - out)) < 2.0 / 32768.0


# ---------------------------------------------------------------------------
# The port imports torch and numpy: never jax, never the JAX package.

PORT_SOURCES = sorted((ROOT / "pyaudiodsptools_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "pyaudiodsptools_tpu")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    assert not _imported_roots(path) & set(FORBIDDEN), path


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import pyaudiodsptools_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert 'pyaudiodsptools_tpu_torch.kernels.tail' in sys.modules\n"
        "assert 'pyaudiodsptools_tpu_torch.kernels.dynamics' in sys.modules\n"
        "assert 'pyaudiodsptools_tpu_torch.profiling' in sys.modules\n"
        "assert 'pyaudiodsptools_tpu_torch.roofline' in sys.modules\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
