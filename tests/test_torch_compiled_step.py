"""PyTorch/CUDA port: the compiled streaming step (``engine/graph.py``).

The JAX package jit-compiles its streaming step; the port captures it in a
CUDA graph on the card and replays it. A capture freezes whatever a step
reads on the host, so the CPU tests hold what that needs of the ops:

* the tremolo's LFO position is two 0-d int32 tensors, bit-equal to the JAX
  tremolo's state and output block after block, its freeze quirk included;
* every op's, every fused effect's, the reverb's and the EQ's initial state
  has only tensor leaves;
* a step of each of them reads no tensor value back to the host: a
  ``TorchFunctionMode`` refuses ``item``, ``tolist``, ``__int__``,
  ``__bool__``, ``cpu``, ``numpy`` (and ``__float__``, ``__index__``,
  ``__complex__``) on any tensor that is not one of the effect's params;
* a checkpoint the JAX processor wrote loads into the port and continues
  with the tremolo and dynamics fields equal to the JAX stream's, and a
  checkpoint with int64 tremolo leaves (as the port wrote them before) still
  loads.

The ``cuda`` tests (skipped without a card) hold the captured step itself:
bit-equal to the eager fold for chain8 and for ``compat`` devices, outputs
that stay valid after later steps, checkpoint and resume, one ``conv_pairs``
and one ``serial_walk`` launch counted a step, no synchronisation in the
replay loop. They import no JAX, so that the file runs on a machine with a
card and no JAX: the tests against the JAX package import it inside
(``_jax``) and skip where it is missing.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu_torch import convert
from pyaudiodsptools_tpu_torch.engine.stream import state_leaves, state_paths
from pyaudiodsptools_tpu_torch.kernels import convpairs, dynamics as kd

import torch_port_util  # noqa: F401  (one torch thread, OpenBLAS limit)

CPU = "cpu"
B = 512
FIELDS = ("mode", "x", "y", "skip")


def _jax():
    """(jax, jax.numpy, the JAX package), or a skip where JAX is missing."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import pyaudiodsptools_tpu as jx
    return jax, jnp, jx


def _chain8_effects(pkg, cfg, **kw):
    o = pkg.ops
    return [o.lowcut(cfg, 120.0, **kw), o.highcut(cfg, 12000.0, **kw),
            o.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5, **kw),
            o.compressor(cfg, -18.0, 0.6, 3.1, 30.1, **kw),
            o.gate(cfg, -45.0, 0.1, 3.1, 200.1, **kw),
            o.delay(cfg, 150.0, 2, **kw),
            o.tremolo(cfg, 0.3, 5.0, **kw), o.softclipper(cfg, 0.44, **kw)]


def _signal(C, n, seed):
    """Noise bursts over a quiet floor (both automatons at work)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    burst = (np.sin(2 * np.pi * t / 1900.0) > 0.2) * 0.6 + 0.002
    return np.clip(rng.standard_normal((C, n)) * 0.3 * burst, -0.99, 0.99
                   ).astype(np.float32)


# ---------------------------------------------------------------------------
# the tremolo's position on the device


@pytest.mark.parametrize("sr,block,lfo_hz", [
    (44100, 512, 4.5), (44100, 4096, 4.5), (48000, 512, 4.5),
    (48000, 4096, 4.5),
    (44100, 512, 44100 / 512),        # L == B: frozen from the first block
    (44100, 512, 44100 / 768)],       # L = 1.5 B: frozen from the third
    ids=["44k-512", "44k-4096", "48k-512", "48k-4096", "frozen-at-once",
         "frozen-later"])
def test_tremolo_state_and_output_bit_equal_to_jax(sr, block, lfo_hz):
    jax, jnp, jx = _jax()
    jeff = jx.ops.tremolo(jx.EngineConfig(sr, block), 0.4, lfo_hz)
    peff = pt.ops.tremolo(pt.EngineConfig(sr, block), 0.4, lfo_hz,
                          device=CPU)
    assert peff.params.lfo_length == jeff.params.lfo_length
    jstep = jax.jit(jeff.step)
    jst, pst = jeff.state((2,)), peff.state((2,))
    rng = np.random.default_rng(block)
    phases = []
    for i in range(64):
        x = rng.standard_normal((2, block)).astype(np.float32)
        jst, jy = jstep(jeff.params, jst, jnp.asarray(x))
        pst, py = peff.step(peff.params, pst, torch.from_numpy(x))
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy),
                                      err_msg=f"block {i}")
        for key in ("phase", "avail"):
            leaf = pst[key]
            assert isinstance(leaf, torch.Tensor) and leaf.shape == () \
                and leaf.dtype == torch.int32, (key, leaf)
            assert np.asarray(jst[key]).dtype == np.int32
            assert int(leaf) == int(jst[key]), (i, key)
        phases.append(int(pst["phase"]))
    L = peff.params.lfo_length
    if L == block:
        assert phases == [0] * 64
    elif 2 * L == 3 * block:
        assert phases[1:] == [L // 3] * 63 and int(pst["avail"]) == block
    else:
        assert len(set(phases)) > 32


# ---------------------------------------------------------------------------
# every op: tensor leaves, and no host read in a step


def _effects():
    """name -> factory(cfg) of every op, each fused effect of chain8, the
    reverb and the EQ, on the CPU."""
    o = pt.ops
    kw = {"device": CPU}
    cases = {
        "lowcut": lambda c: o.lowcut(c, 120.0, **kw),
        "highcut": lambda c: o.highcut(c, 12000.0, **kw),
        "eq3band_fft": lambda c: o.eq3band_fft(
            c, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5, **kw),
        "eq3band": lambda c: o.eq3band(c, 200.0, 3.5, 1000.0, -2.5, 8000.0,
                                       4.0, **kw),
        "eq_band_low": lambda c: o.eq_band(c, "low", 200.0, 3.5, **kw),
        "compressor": lambda c: o.compressor(c, -18.0, **kw),
        "gate": lambda c: o.gate(c, -45.0, **kw),
        "delay": lambda c: o.delay(c, 150.0, 2, **kw),
        "delay_filtered": lambda c: o.delay(
            c, 150.0, 2, use_lowcut_filter=True, use_highcut_filter=True,
            **kw),
        "tremolo": lambda c: o.tremolo(c, 0.3, 5.0, **kw),
        "saturator": lambda c: o.saturator(c, **kw),
        "softclipper": lambda c: o.softclipper(c, **kw),
        "harddistortion": lambda c: o.harddistortion(c, **kw),
        "bitcrusher": lambda c: o.bitcrusher(c, **kw),
        "reverb": lambda c: o.reverb(c, 300.0, **kw),
    }
    for i, name in enumerate(("fir_cascade", "dynamics_cascade", "tail")):
        cases["chain8_" + name] = functools.partial(_fused, i)
    return cases


@functools.lru_cache(maxsize=None)
def _chain8(cfg):
    return pt.Chain(_chain8_effects(pt, cfg, device=CPU), device=CPU)


def _fused(i, cfg):
    return _chain8(cfg).exec_effects[i]


EFFECTS = _effects()


@pytest.mark.parametrize("name", sorted(EFFECTS))
def test_initial_state_has_only_tensor_leaves(name):
    eff = EFFECTS[name](pt.EngineConfig(44100, B))
    for batch in ((), (3,)):
        for path, leaf in state_paths(eff.state(batch)):
            assert isinstance(leaf, torch.Tensor), (name, path, leaf)
            assert leaf.device == eff.device, (name, path)


REFUSED = frozenset({"item", "tolist", "__int__", "__bool__", "cpu", "numpy",
                     "__float__", "__index__", "__complex__"})


def _param_storages(params) -> set:
    """Storage addresses of every tensor in a params tree."""
    found = set()

    def walk(node):
        if isinstance(node, torch.Tensor):
            found.add(node.untyped_storage().data_ptr())
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name))
        elif isinstance(node, (tuple, list)):
            for part in node:
                walk(part)
        elif isinstance(node, dict):
            for part in node.values():
                walk(part)

    walk(params)
    return found


class NoHostRead(TorchFunctionMode):
    """Refuses a read of a tensor's value on the host (what a CUDA graph
    would freeze at capture, or what would synchronise a step) on every
    tensor that is not one of the params' (state, block, and whatever the
    step computes from them)."""

    def __init__(self, params):
        super().__init__()
        self.allowed = _param_storages(params)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in REFUSED and args and isinstance(args[0], torch.Tensor) \
                and args[0].untyped_storage().data_ptr() not in self.allowed:
            raise AssertionError(f"the step read a tensor back: {name} on "
                                 f"{tuple(args[0].shape)} {args[0].dtype}")
        return func(*args, **(kwargs or {}))


def test_the_guard_refuses_a_host_read():
    eff = pt.ops.tremolo(pt.EngineConfig(44100, B), device=CPU)
    st = eff.state()
    with NoHostRead(eff.params):
        with pytest.raises(AssertionError, match="__int__"):
            int(st["phase"])
        with pytest.raises(AssertionError, match="__bool__"):
            bool(st["avail"] > 0)
        float(eff.params.depth)     # a host scalar of the params: allowed


@pytest.mark.parametrize("name", sorted(EFFECTS))
def test_a_step_reads_nothing_back(name):
    eff = EFFECTS[name](pt.EngineConfig(44100, B))
    x = torch.from_numpy(_signal(3, 3 * B, seed=len(name)))
    state = eff.state((3,))
    want_state, outs = state, []
    for i in range(3):
        want_state, y = eff.step(eff.params, want_state,
                                 x[:, i * B:(i + 1) * B])
        outs.append(y)
    with NoHostRead(eff.params):
        for i in range(3):
            state, y = eff.step(eff.params, state, x[:, i * B:(i + 1) * B])
            assert torch.equal(y, outs[i])
    for a, b in zip(state_leaves(state), state_leaves(want_state)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints across packages and versions


def _fields(state, names):
    return {path: leaf for path, leaf in state_paths(state)
            if path[-1] in names}


def _assert_fields_equal(pstate, jstate, what):
    theirs = _jax()[0].tree.flatten(jstate)[0]
    paths = [path for path, _ in state_paths(pstate)]
    assert len(paths) == len(theirs)
    ours = _fields(pstate, FIELDS + ("phase", "avail"))
    assert len(ours) == 10           # two automatons' four fields, the LFO
    for path, leaf in zip(paths, theirs):
        if path in ours:
            assert str(ours[path].dtype) == "torch." + np.asarray(
                leaf).dtype.name, (what, path)
            np.testing.assert_array_equal(ours[path].numpy(),
                                          np.asarray(leaf),
                                          err_msg=f"{what}{path}")


def test_a_jax_checkpoint_continues_in_the_port(tmp_path):
    """The JAX processor streams six blocks of chain8 and saves its state;
    the port loads that ``.npz`` (``convert.state_from_numpy``) and both
    stream six more: the tremolo's and the automatons' fields equal after
    every block (the signal keeps clear of the thresholds, as
    ``test_torch_stream.py`` asserts for the same seed)."""
    _, _, jx = _jax()
    jcfg, pcfg = jx.EngineConfig(44100, B), pt.EngineConfig(44100, B)
    jchain = jx.Chain(_chain8_effects(jx, jcfg))
    pchain = pt.Chain(_chain8_effects(pt, pcfg, device=CPU), device=CPU)
    x = _signal(2, 12 * B, seed=14)
    jsp = jx.StreamProcessor(jchain, jcfg, (2,))
    for i in range(6):
        jsp.process(x[:, i * B:(i + 1) * B])
    ckpt = str(tmp_path / "jax_chain8.npz")
    jsp.save_state(ckpt)
    with np.load(ckpt) as archive:
        leaves = [archive[k] for k in archive.files]
    assert [leaf.dtype for leaf in leaves[-2:]] == [np.int32, np.int32]
    sp = pt.StreamProcessor(pchain, pcfg, (2,))
    sp.state = convert.state_from_numpy(pchain, leaves)
    _assert_fields_equal(sp.state, jsp.state, "hand-over: ")
    for i in range(6, 12):
        blk = x[:, i * B:(i + 1) * B]
        jsp.process(blk)
        sp.process(blk)
        _assert_fields_equal(sp.state, jsp.state, f"block {i}: ")


def test_an_int64_tremolo_checkpoint_still_loads(tmp_path):
    """A checkpoint from before the tremolo's position became int32 tensors
    holds it as int64 scalars: it loads as int32 tensors and continues
    bit-equal to the uninterrupted stream."""
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain([pt.ops.lowcut(cfg, 300.0, device=CPU),
                      pt.ops.tremolo(cfg, 0.5, 3.0, device=CPU)], device=CPU)
    x = _signal(2, 8 * B, seed=3)
    sp = pt.StreamProcessor(chain, cfg, (2,))
    full = [sp.process(x[:, i * B:(i + 1) * B]) for i in range(8)]
    sp2 = pt.StreamProcessor(chain, cfg, (2,))
    for i in range(4):
        sp2.process(x[:, i * B:(i + 1) * B])
    ckpt = str(tmp_path / "state.npz")
    sp2.save_state(ckpt)
    with np.load(ckpt) as archive:
        leaves = [archive[k] for k in archive.files]
    assert [leaf.dtype for leaf in leaves[-2:]] == [np.int32, np.int32]
    old = str(tmp_path / "old.npz")
    np.savez(old, *leaves[:-2], *[np.asarray(int(v)) for v in leaves[-2:]])
    with np.load(old) as archive:
        assert archive[archive.files[-1]].dtype == np.int64
    sp3 = pt.StreamProcessor(chain, cfg, (2,))
    sp3.load_state(old)
    for leaf in state_leaves(sp3.state)[-2:]:
        assert leaf.dtype == torch.int32 and leaf.shape == ()
    for i in range(4, 8):
        np.testing.assert_array_equal(sp3.process(x[:, i * B:(i + 1) * B]),
                                      full[i])


# ---------------------------------------------------------------------------
# on the card: the captured step


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")


def _eager_fold(chain, x, block):
    state = chain.init_state((x.shape[0],))
    outs = []
    for i in range(x.shape[1] // block):
        state, y = chain.step(state, x[:, i * block:(i + 1) * block])
        outs.append(y)
    return torch.cat(outs, -1), state


@pytest.mark.cuda
@pytest.mark.parametrize("block", [512, 4096])
def test_cuda_captured_chain8_bit_equal_to_eager_on_card(block):
    _need_card()
    cfg = pt.EngineConfig(44100, block)
    chain = pt.Chain(_chain8_effects(pt, cfg, device="cuda"), device="cuda")
    x = torch.from_numpy(_signal(4, 12 * block, seed=block)).cuda()
    want, want_state = _eager_fold(chain, x, block)
    sp = pt.StreamProcessor(chain, cfg, (4,))
    sp.warmup()
    got = [sp.process(x[:, i * block:(i + 1) * block]) for i in range(12)]
    assert torch.equal(torch.cat(got, -1), want)
    for a, b in zip(state_leaves(sp.state), state_leaves(want_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_outputs_stay_valid_and_launches_counted_on_card():
    _need_card()
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_chain8_effects(pt, cfg, device="cuda"), device="cuda")
    x = torch.from_numpy(_signal(4, 8 * B, seed=2)).cuda()
    sp = pt.StreamProcessor(chain, cfg, (4,))
    sp.warmup()
    before = (convpairs.launch_count, kd.serial_walk_launch_count)
    outs, copies = [], []
    for i in range(8):
        y = sp.process(x[:, i * B:(i + 1) * B])
        outs.append(y)
        copies.append(y.clone())
    assert (convpairs.launch_count, kd.serial_walk_launch_count) \
        == (before[0] + 8, before[1] + 8)
    for a, b in zip(outs, copies):
        assert torch.equal(a, b)
    # numpy in and out: the same bits
    sp.reset()
    np_out = [sp.process(x[:, i * B:(i + 1) * B].cpu().numpy())
              for i in range(8)]
    np.testing.assert_array_equal(np.concatenate(np_out, -1),
                                  torch.cat(copies, -1).cpu().numpy())


@pytest.mark.cuda
def test_cuda_checkpoint_resume_mid_stream_on_card(tmp_path):
    _need_card()
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_chain8_effects(pt, cfg, device="cuda"), device="cuda")
    x = torch.from_numpy(_signal(4, 8 * B, seed=6)).cuda()
    sp = pt.StreamProcessor(chain, cfg, (4,))
    full = []
    for i in range(8):
        if i == 4:
            sp.save_state(str(tmp_path / "mid.npz"))
        full.append(sp.process(x[:, i * B:(i + 1) * B]))
    sp2 = pt.StreamProcessor(chain, cfg, (4,))
    sp2.load_state(str(tmp_path / "mid.npz"))
    for i in range(4, 8):
        assert torch.equal(sp2.process(x[:, i * B:(i + 1) * B]), full[i])


@pytest.mark.cuda
def test_cuda_replay_loop_does_not_synchronise_on_card():
    _need_card()
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_chain8_effects(pt, cfg, device="cuda"), device="cuda")
    x = torch.from_numpy(_signal(4, 8 * B, seed=8)).cuda()
    sp = pt.StreamProcessor(chain, cfg, (4,))
    sp.warmup()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [sp.process(x[:, i * B:(i + 1) * B]) for i in range(8)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, _ = _eager_fold(chain, x, B)
    assert torch.equal(torch.cat(outs, -1), want)


@pytest.mark.cuda
def test_cuda_compat_devices_bit_equal_to_eager_on_card():
    _need_card()
    from pyaudiodsptools_tpu_torch import compat

    compat.config.initialize(44100, B)
    devices = [compat.CreateLowCutFilter(300), compat.CreateCompressor(-18),
               compat.CreateTremolo(0.3, 5.0), compat.CreateDelay(150, 2),
               compat.CreateReverb(300)]
    x = _signal(1, 6 * B, seed=10)[0]
    for d in devices:
        eff = d._effect
        state = eff.state()
        for i in range(6):
            chunk = x[i * B:(i + 1) * B]
            state, want = eff.step(eff.params, state,
                                   torch.from_numpy(chunk).cuda())
            np.testing.assert_array_equal(d.apply(chunk),
                                          want.cpu().numpy(), err_msg=eff.name)
    # a chunk of a new length captures once for it; the state carries on
    trem = devices[2]
    state = trem._effect.state()
    for n in (B, 300, B, 300):
        chunk = x[:n]
        state, want = trem._effect.step(trem._effect.params, state,
                                        torch.from_numpy(chunk).cuda())
    trem.reset()
    got = [trem.apply(x[:n]) for n in (B, 300, B, 300)]
    np.testing.assert_array_equal(got[-1], want.cpu().numpy())


def _device_kernels(fn) -> tuple[list[str], object]:
    """The names of the device operations ``fn`` ran, and the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation()], prof


@pytest.mark.cuda
def test_cuda_traced_step_marks_its_stages_on_card():
    """Captured with tracing off, the step holds no mark and launches what
    it launched before marks existed; captured with it on, a mark bounds
    each executed effect and the state write-back, the counters count the
    same launches and the outputs are the untraced graph's bits."""
    _need_card()
    from pyaudiodsptools_tpu_torch import profiling

    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_chain8_effects(pt, cfg, device="cuda"), device="cuda")
    x = torch.from_numpy(_signal(4, 8 * B, seed=12)).cuda()
    shape = (4, B)
    plain = chain.captured_step((4,))
    plain.capture(shape)
    profiling.enable()
    try:
        traced = chain.captured_step((4,))
        traced.capture(shape)
    finally:
        profiling.enable(False)
    names = [e.name for e in chain.exec_effects]
    assert plain.stages(shape) == []
    assert traced.stages(shape) == names + ["write_state"]
    assert plain.launches_per_step(shape) == \
        traced.launches_per_step(shape) == \
        {"convpairs.launch_count": 1, "dynamics.serial_walk_launch_count": 1}
    block = x[:, :B]
    ops, _ = _device_kernels(lambda: plain(block))
    marked, prof = _device_kernels(lambda: traced(block))
    marks = [n for n in marked if "trace_mark_kernel" in n]
    assert not any("trace_mark_kernel" in n for n in ops)
    assert len(marks) == len(names) + 2
    assert sorted(n for n in marked if "trace_mark_kernel" not in n) == \
        sorted(ops)
    got = profiling.attribute(prof, traced.stages(shape))
    assert list(got["stages"]) == traced.stages(shape)
    assert got["staged_busy_s"] >= 0.95 * got["replay_busy_s"] > 0
    for i in range(1, 8):
        blk = x[:, i * B:(i + 1) * B]
        assert torch.equal(traced(blk), plain(blk))
