"""PyTorch/CUDA port: the compiled offline render (``engine/graph.py``,
``CapturedRender``; ``kernels/dynamics.py``, the settle step).

The JAX package jit-compiles its whole offline render, its dynamics
fixpoint a ``lax.while_loop`` inside the program; the port captures the
render in a CUDA graph on the card, the fixpoint a conditional while node
whose body is an audio walk and the settle step. The CPU tests hold what
that needs:

* the settle step's plain version against a numpy mirror of JAX's
  ``next_entries`` and its ``done`` test, at C in 1, 3, 64 and G in 1, 2, 16;
* ``dynamics_offline`` through the settle step bit-equal to the loop it
  replaced (shifted exits compared with ``torch.equal``), with the same
  walks, and to the one-segment walk, on the signals of the dynamics tests
  and a burst followed by silence; > 100 dB to the JAX package's kernel in
  interpret mode and to its faithful scan (the bar of
  ``test_torch_dynamics.py``, for its reason: ramps within 2 ulp);
* the tremolo's gain row from the device cache of its phase schedule
  bit-equal to the row computed from the host schedule, its schedule equal
  to the JAX tremolo's and its row within one ulp of it (the two float32
  sines differ there, as ``test_torch_ops.py`` allows);
* chain8's eager render reads nothing back but the settle flags, once a
  walk (a ``TorchFunctionMode`` guard modelled on
  ``test_torch_compiled_step.py``'s);
* a captured render refuses a CPU chain;
* ``graph_cond.fixpoints`` records each fixpoint's flags and walks, and the
  kernel layer does not import the engine.

The ``cuda`` tests (skipped without a card) hold the captured render itself
(bit-equal to eager, also with a lone soft clipper's one-stage tail launch
and no kernel plan built in the capture; the while node's walks against
the plain render's, no synchronisation in a replay, outputs that stay valid, one graph kept by
``render`` over signals of many lengths), the settle kernel against its
plain version and in a while node of its own, and import no JAX, so that ``python -m pytest --noconftest -m cuda
tests/test_torch_compiled_render.py`` runs on a machine with a card and no
JAX (``tests/conftest.py`` imports JAX).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu_torch.engine import graph as eg
from pyaudiodsptools_tpu_torch.kernels import dynamics as kd
from pyaudiodsptools_tpu_torch.kernels import graph_cond as kgc
from pyaudiodsptools_tpu_torch.kernels import relayout as rl
from pyaudiodsptools_tpu_torch.kernels import tail as kt

# the module (``ops.tremolo`` is its factory)
trem = importlib.import_module("pyaudiodsptools_tpu_torch.ops.tremolo")

from torch_port_util import snr_db

CPU = "cpu"
N = 12000       # longer than the gate's release (8,824 samples)


def _jax():
    """(jax.numpy, the JAX package), or a skip where JAX is missing."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import pyaudiodsptools_tpu as jx
    return jnp, jx


def _dyn(pkg, cfg, **kw):
    """The flagship cascade's two automatons (chain8's arguments)."""
    return [pkg.ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1, **kw),
            pkg.ops.gate(cfg, -45.0, 0.1, 3.1, 200.1, **kw)]


def _chain8_effects(pkg, cfg, **kw):
    o = pkg.ops
    return [o.lowcut(cfg, 120.0, **kw), o.highcut(cfg, 12000.0, **kw),
            o.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5, **kw),
            *_dyn(pkg, cfg, **kw),
            o.delay(cfg, 150.0, 2, **kw),
            o.tremolo(cfg, 0.3, 5.0, **kw), o.softclipper(cfg, 0.44, **kw)]


def _signals(n=N):
    """The dynamics tests' signals (``test_torch_dynamics.py``) and a burst
    of noise followed by silence, whose gate release (8,824 samples) hands
    its state on across many segments: the loop takes many walks."""
    rng = np.random.default_rng(42)
    decay = np.zeros((2, n), np.float32)
    decay[:, 100:400] = 0.5
    decay[1, 9500:9600] = -0.5
    burst = np.zeros((2, n), np.float32)
    burst[:, :1500] = rng.standard_normal((2, 1500)) * 0.4
    return {
        "decay": decay,
        "bursty": (rng.standard_normal((2, n)) * 0.3
                   * (rng.random((2, n)) > 0.5)).astype(np.float32),
        "alternating": np.tile([0.9, 1e-4], n // 2)[None, :].repeat(
            2, 0).astype(np.float32),
        "burst_then_silence": np.clip(burst, -0.99, 0.99),
    }


SIGNALS = _signals()


def _noise_bursts(C, n, seed):
    """Noise bursts over a quiet floor (both automatons at work)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    burst = (np.sin(2 * np.pi * t / 1900.0) > 0.2) * 0.6 + 0.002
    return np.clip(rng.standard_normal((C, n)) * 0.3 * burst, -0.99, 0.99
                   ).astype(np.float32)


# ---------------------------------------------------------------------------
# the settle step


def _mirror_settle(z: np.ndarray, e: np.ndarray, C: int):
    """JAX's ``next_entries`` and ``jnp.all`` in numpy: segment g+1 of
    channel c (lane (g+1)*C + c) takes lane g*C + c's exit, segment 0
    keeps REST; done where nothing changed."""
    nxt = np.zeros_like(z)
    nxt[:, C:] = z[:, :z.shape[1] - C]
    return nxt, bool(np.array_equal(nxt, e))


@pytest.mark.parametrize("G", [1, 2, 16])
@pytest.mark.parametrize("C", [1, 3, 64])
def test_settle_plain_matches_the_numpy_mirror(C, G):
    rng = np.random.default_rng(C * 100 + G)
    R = C * G
    for n_ops in (1, 2, kd.MAX_OPS):
        z = rng.integers(-1, 400, (n_ops, R)).astype(np.int32)
        nxt, _ = _mirror_settle(z, None, C)
        for e0 in (rng.integers(-1, 400, (n_ops, R)).astype(np.int32), nxt):
            want, done = _mirror_settle(z, e0, C)
            e = torch.from_numpy(e0.copy())
            flags = torch.tensor([7, 3, 5, 0], dtype=torch.int32)
            kd.settle(torch.from_numpy(z), e, flags, C, kd.AFTER_AUDIO_WALK)
            np.testing.assert_array_equal(e.numpy(), want)
            assert flags.tolist() == [int(done), 4, 6, 0]
            # after the state walk: one walk, the audio-walk count untouched
            e = torch.from_numpy(e0.copy())
            kd.settle(torch.from_numpy(z), e, flags, C, kd.AFTER_STATE_WALK)
            np.testing.assert_array_equal(e.numpy(), want)
            assert flags.tolist() == [int(done), 1, 6, 0]


def test_settle_refuses_what_its_kernel_does_not_take():
    z = torch.zeros((2, 12), dtype=torch.int32)
    e = torch.zeros_like(z)
    flags = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        kd.settle(z.to(torch.int64), e, flags, 3, kd.AFTER_AUDIO_WALK)
    with pytest.raises(ValueError, match="of its own"):
        kd.settle(z, z, flags, 3, kd.AFTER_AUDIO_WALK)
    with pytest.raises(ValueError, match="flags"):
        kd.settle(z, e, torch.zeros(3, dtype=torch.int32), 3,
                  kd.AFTER_AUDIO_WALK)
    with pytest.raises(ValueError, match="lanes"):
        kd.settle(z, e, flags, 5, kd.AFTER_AUDIO_WALK)
    with pytest.raises(ValueError, match="mode"):
        kd.settle(z, e, flags, 3, 7)
    with pytest.raises(ValueError, match="card only"):
        kd.settle(z, e, flags, 3, kd.IN_WHILE_NODE)


def test_walks_write_into_given_buffers():
    """``out`` and ``exit_state``: the same results written in place (the
    while node's body allocates nothing); a buffer that aliases an input is
    refused."""
    scalars = [kd.op_scalars(e.params) for e in _dyn(
        pt, pt.EngineConfig(44100, 512), device=CPU)]
    x = torch.from_numpy(SIGNALS["bursty"][:, :5037].copy())
    G, L, _ = rl.geometry(2, 5037, 5)
    e = torch.zeros((2, 2 * G), dtype=torch.int32)
    want_out, want_z = kd.audio_walk(scalars, x, G, L, e)
    out, z = torch.full_like(x, np.nan), torch.full_like(e, -7)
    got_out, got_z = kd.audio_walk(scalars, x, G, L, e, out=out,
                                   exit_state=z)
    assert got_out is out and got_z is z
    assert torch.equal(out, want_out) and torch.equal(z, want_z)
    z2 = torch.full_like(e, -7)
    assert kd.state_walk(scalars, x, G, L, e, exit_state=z2) is z2
    assert torch.equal(z2, want_z)
    with pytest.raises(ValueError, match="of its own"):
        kd.audio_walk(scalars, x, G, L, e, exit_state=e)
    with pytest.raises(ValueError, match="out"):
        kd.audio_walk(scalars, x, G, L, e, out=x)
    with pytest.raises(ValueError, match="exit_state"):
        kd.state_walk(scalars, x, G, L, e,
                      exit_state=torch.zeros((2, G), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the fixpoint through the settle step


def _torch_equal_loop(scalars, x, G, L):
    """The fixpoint loop the settle step replaced: shifted exits compared
    with ``torch.equal``. Returns (out, walks)."""
    C = x.shape[0]
    R = C * G

    def next_entries(z):
        e = torch.zeros_like(z)
        e[:, C:R] = z[:, :R - C]
        return e

    e = next_entries(kd.state_walk(
        scalars, x, G, L, torch.zeros((len(scalars), R), dtype=torch.int32)))
    for walks in range(2, G + 3):
        out, z = kd.audio_walk(scalars, x, G, L, e)
        e_next = next_entries(z)
        if torch.equal(e_next, e):
            return out, walks
        e = e_next
    raise AssertionError("unsettled")


def _counted_walks(monkeypatch):
    walks = []
    for name in ("state_walk", "audio_walk"):
        real = getattr(kd, name)

        def wrapped(*a, _real=real, _name=name, **k):
            walks.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(kd, name, wrapped)
    return walks


@pytest.mark.parametrize("segments", [5, 16])
@pytest.mark.parametrize("signal", sorted(SIGNALS))
def test_fixpoint_through_the_settle_step_equals_the_old_loop_and_jax(
        signal, segments, monkeypatch):
    jnp, jx = _jax()
    from pyaudiodsptools_tpu.kernels import dynamics_pallas as jx_dp

    cfg = pt.EngineConfig(44100, 512)
    params = [e.params for e in _dyn(pt, cfg, device=CPU)]
    scalars = [kd.op_scalars(p) for p in params]
    x = torch.from_numpy(SIGNALS[signal])
    G, L, _ = rl.geometry(2, N, segments)
    want, want_walks = _torch_equal_loop(scalars, x, G, L)
    walks = _counted_walks(monkeypatch)
    before = kd.settle_launch_count
    got = kd.dynamics_offline(params, x, segments=segments)
    assert torch.equal(got, want), signal
    assert walks[0] == "state_walk" and set(walks[1:]) == {"audio_walk"}
    assert len(walks) == want_walks, (signal, walks)
    assert kd.settle_launch_count == before        # plain: no launch
    monkeypatch.undo()
    assert torch.equal(got, kd.dynamics_offline(params, x, segments=1))
    if signal == "burst_then_silence" and segments == 16:
        assert want_walks >= 8          # the release crosses many segments
    jeffs = _dyn(jx, jx.EngineConfig(44100, 512))
    y = jnp.asarray(SIGNALS[signal])
    for e in jeffs:
        _, y = e.step(e.params, e.init_state(e.params, (2,)), y)
    assert snr_db(np.asarray(y), got.numpy()) > 100.0
    if segments == 5:
        kern = jx_dp.dynamics_pallas_offline(
            [e.params for e in jeffs], jnp.asarray(SIGNALS[signal]),
            segments=5, interpret=True)
        assert snr_db(np.asarray(kern), got.numpy()) > 100.0


def test_fixpoints_record_each_eager_fixpoint_and_its_walks():
    """``graph_cond.fixpoints`` collects the settle flags of each fixpoint
    run inside it, in order; an eager fixpoint's flags hold its walks, the
    old loop's count. Outside a ``fixpoints`` block nothing is kept."""
    cfg = pt.EngineConfig(44100, 512)
    params = [e.params for e in _dyn(pt, cfg, device=CPU)]
    scalars = [kd.op_scalars(p) for p in params]
    runs = []
    for name in ("decay", "burst_then_silence"):
        x = torch.from_numpy(SIGNALS[name])
        G, L, _ = rl.geometry(2, N, 16)
        runs.append((x, _torch_equal_loop(scalars, x, G, L)[1]))
    with kgc.fixpoints() as found:
        for x, _ in runs:
            kd.dynamics_offline(params, x, segments=16)
    assert [int(f[kd.FLAG_WALKS]) for f in found] == [w for _, w in runs]
    assert [int(f[kd.FLAG_AUDIO_WALKS]) for f in found] \
        == [w - 1 for _, w in runs]
    assert all(int(f[kd.FLAG_DONE]) == 1 and int(f[kd.FLAG_UNSETTLED]) == 0
               for f in found)
    with kgc.fixpoints() as outer:
        with kgc.fixpoints() as inner:
            kd.dynamics_offline(params, runs[0][0], segments=16)
        kd.dynamics_offline(params, runs[0][0], segments=16)
    assert len(inner) == 1 and len(outer) == 1
    kgc.note_fixpoint(torch.zeros(4, dtype=torch.int32))    # dropped


def test_the_kernel_layer_does_not_reach_into_the_engine():
    """The while node and the record of fixpoints are the kernel layer's
    (``kernels/graph_cond.py``); ``engine/graph.py`` only reads them."""
    import pathlib

    kernels = pathlib.Path(kd.__file__).parent
    for path in sorted(kernels.glob("*.py")):
        text = path.read_text()
        assert "from ..engine" not in text and "engine import" not in text, \
            path.name
    assert eg.CaptureError is kgc.CaptureError


# ---------------------------------------------------------------------------
# the tremolo's gain row from the device cache


@pytest.mark.parametrize("sr,B,nb,first", [
    (44100, 512, 40, 0), (44100, 4096, 12, 0), (48000, 512, 40, 7),
    (44100, 512, 44100 // 512 + 3, 0)],
    ids=["44k-512", "44k-4096", "48k-512-shard", "past-a-period"])
def test_gain_row_from_the_device_cache(sr, B, nb, first):
    _, jx = _jax()
    peff = pt.ops.tremolo(pt.EngineConfig(sr, B), 0.3, 5.0, device=CPU)
    p = peff.params
    got = trem.gain_row(p, nb, B, first_block=first)
    # the row as computed from the host schedule, copied per call
    phases = torch.from_numpy(
        trem.phase_schedule(p, first + nb, B)[first:].copy())
    idx = (phases[:, None] + torch.arange(B)[None, :]) % p.lfo_length
    ph = idx.to(torch.float32) * p.omega
    want = ((torch.sin(ph) * 0.5 + 0.5) * p.depth
            + (1.0 - p.depth)).reshape(-1)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    # the schedule is copied once per key and device and kept
    key = (p.lfo_length, first + nb, B, "cpu")
    cached = trem._device_schedules[key]
    again = trem.gain_row(p, nb, B, first_block=first)
    assert trem._device_schedules[key] is cached and torch.equal(again, got)
    if first == 0:
        # the JAX tremolo's schedule exactly; its row within one ulp (XLA's
        # float32 sin and PyTorch's round a few samples in a thousand the
        # other way, the cache or not: test_torch_ops.py holds the offline
        # tremolo to JAX's at 120 dB for that reason)
        jx_trem = importlib.import_module("pyaudiodsptools_tpu.ops.tremolo")
        jeff = jx.ops.tremolo(jx.EngineConfig(sr, B), 0.3, 5.0)
        np.testing.assert_array_equal(
            cached.numpy(), jx_trem.phase_schedule(jeff.params, nb, B))
        jrow = np.asarray(jx_trem.gain_row(jeff.params, nb, B))
        assert np.all(np.abs(got.numpy() - jrow)
                      <= np.spacing(np.abs(jrow))), "more than one ulp"
        assert snr_db(jrow, got.numpy()) >= 120.0


# ---------------------------------------------------------------------------
# no host read in the eager render but the settle flags


REFUSED = frozenset({"item", "tolist", "__int__", "__bool__", "cpu", "numpy",
                     "__float__", "__index__", "__complex__"})


def _param_storages(params) -> set:
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


class NoHostReadButFlags(TorchFunctionMode):
    """Refuses a read of a tensor's value on the host, as
    ``test_torch_compiled_step.NoHostRead`` does, except on the params'
    tensors and on the settle step's flags (whose storages ``flag_storages``
    holds); counts the flags' reads."""

    def __init__(self, params, flag_storages: set):
        super().__init__()
        self.allowed = _param_storages(params)
        self.flags = flag_storages
        self.flag_reads = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in REFUSED and args and isinstance(args[0], torch.Tensor):
            ptr = args[0].untyped_storage().data_ptr()
            if ptr in self.flags:
                self.flag_reads += 1
            elif ptr not in self.allowed:
                raise AssertionError(
                    f"the render read a tensor back: {name} on "
                    f"{tuple(args[0].shape)} {args[0].dtype}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("B", [512, 4096])
def test_chain8_render_reads_back_only_the_settle_flags(B, monkeypatch):
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_chain8_effects(pt, cfg, device=CPU), device=CPU)
    nb = 16 if B == 512 else 3
    x = torch.from_numpy(_noise_bursts(2, nb * B, seed=B)).reshape(2, nb, B)
    want = chain.render_blocks(x)
    flag_storages, audio_walks = set(), []
    real_settle = kd.settle

    def settle(z, e, flags, C, mode, *a, **k):
        flag_storages.add(flags.untyped_storage().data_ptr())
        audio_walks.append(mode == kd.AFTER_AUDIO_WALK)
        return real_settle(z, e, flags, C, mode, *a, **k)

    monkeypatch.setattr(kd, "settle", settle)
    with NoHostReadButFlags(chain.params, flag_storages) as guard:
        got = chain.render_blocks(x)
    assert torch.equal(got, want)
    assert sum(audio_walks) >= 1 and not audio_walks[0]
    assert guard.flag_reads == sum(audio_walks)      # once a walk


def test_the_guard_refuses_a_host_read():
    eff = pt.ops.tremolo(pt.EngineConfig(44100, 512), device=CPU)
    flags = torch.zeros(4, dtype=torch.int32)
    with NoHostReadButFlags(eff.params,
                            {flags.untyped_storage().data_ptr()}) as guard:
        with pytest.raises(AssertionError, match="tolist"):
            torch.zeros(3).tolist()
        flags[:2].tolist()
        float(eff.params.depth)
    assert guard.flag_reads == 1


# ---------------------------------------------------------------------------
# the CPU keeps the eager render


def test_captured_render_refuses_a_cpu_chain():
    cfg = pt.EngineConfig(44100, 512)
    chain = pt.Chain([pt.ops.lowcut(cfg, 300.0, device=CPU)], device=CPU)
    with pytest.raises(ValueError, match="card"):
        chain.captured_render()
    with pytest.raises(ValueError, match="CUDA device"):
        eg.CapturedRender(chain.exec_effects, CPU)


def test_render_on_the_cpu_is_the_eager_render():
    """``render`` on a CPU chain blocks, renders eagerly and deblocks, as
    before; ``render_segmented`` folds ``Chain.step``."""
    cfg = pt.EngineConfig(44100, 512)
    chain = pt.Chain(_chain8_effects(pt, cfg, device=CPU), device=CPU)
    x = torch.from_numpy(_noise_bursts(2, 10 * 512 - 100, seed=4))
    got = pt.render(chain, x, cfg)
    want = chain.render_blocks(pt.block.make_blocks(x, 512)).reshape(2, -1)
    assert torch.equal(got, want) and chain._captured_render is None
    seg = pt.render_segmented(chain, x, cfg, segment_blocks=3)
    state = chain.init_state((2,))
    blocks = pt.block.make_blocks(x, 512)
    outs = []
    for i in range(blocks.shape[-2]):
        state, y = chain.step(state, blocks[:, i])
        outs.append(y)
    assert torch.equal(seg, torch.cat(outs, -1)) and not chain._fold_steps


# ---------------------------------------------------------------------------
# on the card: the captured render


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")


def _card_chain(B):
    cfg = pt.EngineConfig(44100, B)
    return cfg, pt.Chain(_chain8_effects(pt, cfg, device="cuda"),
                         device="cuda")


def _eager_walks(chain, blocks):
    before = kd.state_walk_launch_count + kd.audio_walk_launch_count
    out = chain.render_blocks(blocks)
    return out, kd.state_walk_launch_count + kd.audio_walk_launch_count \
        - before


@pytest.mark.cuda
@pytest.mark.parametrize("B", [512, 4096])
def test_cuda_captured_render_bit_equal_to_eager_on_card(B):
    _need_card()
    cfg, chain = _card_chain(B)
    nb = 48 if B == 512 else 8
    x = torch.from_numpy(_noise_bursts(4, nb * B - 77, seed=B)).cuda()
    blocks = pt.block.make_blocks(x, B)
    want, walks = _eager_walks(chain, blocks)
    captured = chain.captured_render()
    assert torch.equal(captured(blocks), want)
    assert captured.walks()[tuple(blocks.shape)] == [walks]
    assert torch.equal(pt.render(chain, x, cfg),
                       want.reshape(4, -1))
    assert chain.captured_render() is captured


@pytest.mark.cuda
def test_cuda_captured_lone_clipper_render_bit_equal_to_eager_on_card(
        monkeypatch):
    """compressor -> gate -> softclipper: the clipper stays alone, and its
    offline is one launch of the tail kernel. The captured render is
    bit-equal to the eager one, a replay launches the tail kernel once, and
    the capture builds no plan: the clipper's was built with it."""
    _need_card()
    B = 4096
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_dyn(pt, cfg, device="cuda")
                     + [pt.ops.softclipper(cfg, 0.44, device="cuda")],
                     device="cuda")
    assert [e.name for e in chain.exec_effects] == \
        ["dynamics_cascade:compressor+gate", "softclipper"]
    built = []
    make_plan = kt.make_plan

    def spy(*args, **kwargs):
        built.append(torch.cuda.is_current_stream_capturing())
        return make_plan(*args, **kwargs)

    monkeypatch.setattr(kt, "make_plan", spy)
    # past full scale in the bursts: the clipper's clamp at work
    x = torch.from_numpy(_noise_bursts(4, 8 * B - 77, seed=3) * 1.5).cuda()
    blocks = pt.block.make_blocks(x, B)
    before = kt.launch_count
    want, walks = _eager_walks(chain, blocks)
    assert kt.launch_count == before + 1
    captured = chain.captured_render()
    got = captured(blocks)
    assert torch.equal(got, want)
    assert captured.walks()[tuple(blocks.shape)] == [walks]
    before = kt.launch_count
    assert torch.equal(captured(blocks), want)
    assert kt.launch_count == before + 1
    assert torch.equal(pt.render(chain, x, cfg), want.reshape(4, -1))
    assert built == []


@pytest.mark.cuda
def test_cuda_while_node_iterates_on_card():
    """A burst followed by silence at many segments: the fixpoint takes
    many walks inside the graph, bit-equal to the eager loop, and the audio
    walks are counted when the walks are read."""
    _need_card()
    cfg, chain = _card_chain(512)
    C, n = 8, 160 * 512
    x = np.zeros((C, n), np.float32)
    x[:, :3000] = _noise_bursts(C, 3000, seed=5) * 2.0
    xb = pt.block.make_blocks(torch.from_numpy(x).cuda(), 512)
    want, walks = _eager_walks(chain, xb)
    assert walks > 3
    captured = chain.captured_render()
    got = captured(xb)
    torch.cuda.synchronize()
    audio = kd.audio_walk_launch_count
    assert captured.walks()[tuple(xb.shape)] == [walks]
    assert kd.audio_walk_launch_count == audio + walks - 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_render_replay_does_not_synchronise_on_card():
    _need_card()
    cfg, chain = _card_chain(512)
    x = torch.from_numpy(_noise_bursts(4, 24 * 512, seed=9)).cuda()
    want = pt.render(chain, x, cfg)         # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [pt.render(chain, x, cfg) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for o in outs:
        assert torch.equal(o, want)


@pytest.mark.cuda
def test_cuda_outputs_stay_valid_with_two_shapes_on_card():
    """Two shapes' graphs live at once through ``captured(blocks)``, and an
    earlier output stays valid after later replays; ``render`` keeps the
    graph of the shape it renders only."""
    _need_card()
    cfg, chain = _card_chain(512)
    a = torch.from_numpy(_noise_bursts(4, 24 * 512, seed=1)).cuda()
    b = torch.from_numpy(_noise_bursts(2, 40 * 512, seed=2)).cuda()
    ab, bb = pt.block.make_blocks(a, 512), pt.block.make_blocks(b, 512)
    captured = chain.captured_render()
    ya = captured(ab)
    keep = ya.clone()
    yb = captured(bb)
    ya2 = captured(ab * 0.5)
    captured(bb * 0.5)
    assert torch.equal(ya, keep) and not torch.equal(ya2, ya)
    assert torch.equal(yb, chain.render_blocks(bb))
    assert sorted(captured.shapes()) == sorted([tuple(ab.shape),
                                                tuple(bb.shape)])
    assert torch.equal(pt.render(chain, a, cfg), keep.reshape(4, -1))
    assert captured.shapes() == [tuple(ab.shape)]
    captured.release()
    assert captured.shapes() == []
    assert torch.equal(pt.render(chain, a, cfg), keep.reshape(4, -1))


@pytest.mark.cuda
def test_cuda_render_of_many_lengths_holds_one_graph_on_card():
    """One chain renders signals of several lengths: its memory does not
    pile up. After each render (and ``empty_cache``) the card holds what one
    graph of that shape holds, not the graphs of every length met."""
    _need_card()
    cfg, chain = _card_chain(512)
    lengths = (400 * 512, 240 * 512, 400 * 512, 320 * 512 - 5, 400 * 512)
    x = torch.from_numpy(_noise_bursts(16, max(lengths), seed=6)).cuda()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    held = []
    for n in lengths:
        y = pt.render(chain, x[:, :n], cfg)
        del y
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held.append(torch.cuda.memory_reserved() - base)
        assert len(chain.captured_render().shapes()) == 1
    # the longest shape's graph, three times over: the same memory each
    # time, but for the small caches a length adds (the tremolo's schedule)
    slack = 4 * 2**20
    assert held[2] <= held[0] + slack and held[4] <= held[0] + slack, held
    assert held[1] < held[0] and held[3] < held[0], held
    # released, the graph's pool goes back: what stays is the caches (the
    # tremolo's schedules, one a length, which graphs captured keep using)
    chain.captured_render().release()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() - base < min(held) / 2, held


@pytest.mark.cuda
@pytest.mark.parametrize("settled", [False, True])
def test_cuda_settle_kernel_equals_its_plain_version_on_card(settled):
    """The settle kernel against ``settle_plain`` on copies of the same
    inputs, at chain8's (2, 64 x 256) entries: the entries and all four
    flags exactly, after the state walk and after an audio walk."""
    _need_card()
    C, G = 64, 256
    gen = torch.Generator().manual_seed(11 + settled)
    z = torch.randint(-1, 3000, (2, C * G), generator=gen, dtype=torch.int32)
    e = torch.randint(-1, 3000, (2, C * G), generator=gen, dtype=torch.int32)
    if settled:
        e[:, C:] = z[:, :-C]
        e[:, :C] = 0
    for mode in (kd.AFTER_STATE_WALK, kd.AFTER_AUDIO_WALK):
        flags = torch.tensor([5, 9, 4, 2], dtype=torch.int32)
        want_e, want_f = e.clone(), flags.clone()
        kd.settle_plain(z, want_e, want_f, C, mode)
        got_e, got_f = e.cuda(), flags.cuda()
        kd.settle(z.cuda(), got_e, got_f, C, mode)
        assert torch.equal(got_e.cpu(), want_e)
        assert got_f.tolist() == want_f.tolist()
        assert want_f[kd.FLAG_DONE] == int(settled)


@pytest.mark.cuda
@pytest.mark.parametrize("limit", [3, 9])
def test_cuda_settle_kernel_drives_a_while_node_on_card(limit):
    """The settle kernel in a while node, its exits changed every walk (the
    entries never settle) or left alone (they settle at the second): the
    node runs the walks that the loop on the host runs, stops at ``limit``
    and counts a loop that ends there unsettled."""
    _need_card()
    C, G = 8, 16
    for moving in (True, False):
        z0 = torch.randint(0, 50, (2, C * G), dtype=torch.int32)
        # the host's loop over the plain version
        z, e, f = z0.clone(), torch.zeros_like(z0), torch.zeros(
            4, dtype=torch.int32)
        kd.settle_plain(z, e, f, C, kd.AFTER_STATE_WALK)
        unsettled = 0
        while True:
            if moving:
                z.add_(1)
            kd.settle_plain(z, e, f, C, kd.AFTER_AUDIO_WALK)
            if f[kd.FLAG_DONE]:
                break
            if f[kd.FLAG_WALKS] >= limit:
                unsettled = 1
                break
        want = f.tolist()[:3] + [unsettled]
        # the same in a graph
        zc, ec = z0.cuda(), torch.zeros_like(z0).cuda()
        fc = torch.zeros(4, dtype=torch.int32, device="cuda")
        kgc.body_stream(torch.device("cuda"))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            kd.settle(zc, ec, fc, C, kd.AFTER_STATE_WALK)
            with kgc.while_node("cuda") as handle:
                if moving:
                    zc.add_(1)
                kd.settle(zc, ec, fc, C, kd.IN_WHILE_NODE, limit, handle)
        fc.zero_()
        zc.copy_(z0)
        graph.replay()
        assert fc.tolist() == want, (moving, fc.tolist(), want)
        assert torch.equal(ec.cpu(), e)


@pytest.mark.cuda
def test_cuda_while_node_walks_equal_the_plain_render_on_card():
    """A burst followed by silence through chain8's dynamics pair, many
    walks: the captured render against the plain render
    (``use_kernels=False``, every walk and settle step a plain version) on
    the same input, the output and the walk count exactly."""
    _need_card()
    cfg = pt.EngineConfig(44100, 512)
    chain = pt.Chain(_dyn(pt, cfg, device="cuda"), device="cuda")
    C, n = 2, 96 * 512
    x = np.zeros((C, n), np.float32)
    x[:, :3000] = _noise_bursts(C, 3000, seed=5) * 2.0
    xb = pt.block.make_blocks(torch.from_numpy(x).cuda(), 512)
    with kgc.fixpoints() as found:
        plain = chain.render_blocks(xb, use_kernels=False)
    plain_walks = [int(f[kd.FLAG_WALKS]) for f in found]
    captured = chain.captured_render()
    got = captured(xb)
    assert captured.walks()[tuple(xb.shape)] == plain_walks
    assert plain_walks[0] > 3
    assert torch.equal(got, plain)


@pytest.mark.cuda
def test_cuda_render_segmented_through_the_captured_step_on_card():
    _need_card()
    cfg, chain = _card_chain(512)
    x = torch.from_numpy(_noise_bursts(4, 20 * 512 - 9, seed=3)).cuda()
    seg = pt.render_segmented(chain, x, cfg, segment_blocks=6)
    blocks = pt.block.make_blocks(x, 512)
    state = chain.init_state((4,))
    outs = []
    for i in range(blocks.shape[-2]):
        state, y = chain.step(state, blocks[:, i])
        outs.append(y)
    assert torch.equal(seg, torch.cat(outs, -1))
    assert list(chain._fold_steps) == [(4,)]


@pytest.mark.cuda
def test_cuda_traced_render_marks_its_stages_on_card(tmp_path):
    """A render captured under ``profiling.trace`` marks each executed
    effect: the same launches and bits as a graph captured untraced (which
    holds no stage), its spans and stages read back from the trace, every
    replayed operation between two marks."""
    _need_card()
    from pyaudiodsptools_tpu_torch import profiling

    cfg, chain = _card_chain(4096)
    x = torch.from_numpy(_noise_bursts(4, 8 * 4096 - 77, seed=3)).cuda()
    want = pt.render(chain, x, cfg)
    (shape,) = chain.captured_render().shapes()
    assert chain.captured_render().stages(shape) == []
    launches = chain.captured_render().launches_per_replay(shape)
    _, traced_chain = _card_chain(4096)
    with profiling.trace(str(tmp_path)) as prof:
        got = [pt.render(traced_chain, x, cfg) for _ in range(2)]
    assert not profiling.enabled()
    captured = traced_chain.captured_render()
    names = [e.name for e in traced_chain.exec_effects]
    assert captured.stages(shape) == names
    assert captured.launches_per_replay(shape) == launches
    assert all(torch.equal(g, want) for g in got)
    read = profiling.attribute(prof, captured.stages(shape))
    assert list(read["stages"]) == names
    assert all(s["replays"] == 2 for s in read["stages"].values())
    assert read["staged_busy_s"] >= 0.95 * read["replay_busy_s"] > 0
    spans = read["spans"]
    assert spans["graph.capture"]["count"] == 1
    assert spans["render"]["count"] == 2
    for part in ("render.copy_in", "render.replay", "render.copy_out"):
        assert spans[part]["count"] == 2 and spans[part]["device_s"] > 0
