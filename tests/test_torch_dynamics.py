"""PyTorch/CUDA port, the dynamics stage: compressor / gate factories, the
faithful step, and the speculative segment-parallel walks
(``kernels/dynamics.py``) against the JAX package on the CPU.

The same numpy inputs go to both packages. The port runs with
``device="cpu"``, i.e. the plain versions of its kernels; the JAX side runs
its faithful ``lax.scan`` and its Pallas kernels with ``interpret=True``, as
its own tests do. ``emulate_walk`` (tests/torch_port_util.py) is a third,
scalar reading of the automaton, written the way one CUDA thread runs it.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyaudiodsptools_tpu as jx
import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu.kernels import dynamics_pallas as jx_dp
from pyaudiodsptools_tpu_torch.kernels import dynamics as kd, relayout as rl
from pyaudiodsptools_tpu_torch.ops import dynamics as pt_dyn

from torch_port_util import (advance_quiet, emulate_serial_walk, emulate_walk,
                             snr_db)

CPU = "cpu"
JCFG = jx.EngineConfig(44100, 512)
PCFG = pt.EngineConfig(44100, 512)

# name -> (factory name, arguments). "chain8_*" are the flagship chain's
# arguments; "short_attack" has x_max == 1, where ATTACK collapses (a trigger
# jumps straight to HOLD) and the hold gain (1.0) differs from release_env[0].
OPS = {
    "compressor_default": ("compressor", ()),
    "gate_default": ("gate", ()),
    "chain8_compressor": ("compressor", (-18.0, 0.6, 3.1, 30.1)),
    "chain8_gate": ("gate", (-45.0, 0.1, 3.1, 200.1)),
    "short_attack": ("compressor", (-20.0, 0.5, 1000.0 / 44100.0, 2.0)),
}
# what the offline tests walk: single ops and the flagship cascade
CASCADES = {
    "compressor": ("chain8_compressor",),
    "gate": ("chain8_gate",),
    "cascade": ("chain8_compressor", "chain8_gate"),
}
N = 12000       # longer than the gate's release (8,824 samples)


def _jx(name):
    fac, args = OPS[name]
    return getattr(jx.ops, fac)(JCFG, *args)


def _pt(name):
    fac, args = OPS[name]
    return getattr(pt.ops, fac)(PCFG, *args, device=CPU)


def _signals(n=N):
    """The three signals of the JAX package's speculative-dynamics tests,
    which all synchronise within a segment (two walks), and a fourth that
    does not: short bursts followed by silence, so that the gate's release
    (8,824 samples) spans many segments and the loop must hand states on."""
    rng = np.random.default_rng(42)
    decay = np.zeros((2, n), np.float32)
    decay[:, 100:400] = 0.5
    decay[1, 9500:9600] = -0.5
    return {
        "decay": decay,
        "bursty": (rng.standard_normal((2, n)) * 0.3
                   * (rng.random((2, n)) > 0.5)).astype(np.float32),
        # hovers around the threshold with no synchronising window anywhere:
        # drives the loop towards its serial worst case
        "alternating": np.tile([0.9, 1e-4], n // 2)[None, :].repeat(
            2, 0).astype(np.float32),
        "silence": np.zeros((2, n), np.float32),
    }


SIGNALS = _signals()


@functools.lru_cache(maxsize=None)
def _serial(cascade: str, signal: str) -> torch.Tensor:
    """The port's serial oracle: the plain walk with ONE segment."""
    params = [_pt(n).params for n in CASCADES[cascade]]
    return kd.dynamics_offline(params, torch.from_numpy(SIGNALS[signal]),
                               segments=1)


@functools.lru_cache(maxsize=None)
def _jax_scan_fold(cascade: str, signal: str) -> np.ndarray:
    y = jnp.asarray(SIGNALS[signal])
    for n in CASCADES[cascade]:
        e = _jx(n)
        _, y = e.step(e.params, e.init_state(e.params, (y.shape[0],)), y)
    return np.asarray(y)


@functools.lru_cache(maxsize=None)
def _jax_kernel(cascade: str, signal: str) -> np.ndarray:
    params = [_jx(n).params for n in CASCADES[cascade]]
    return np.asarray(jx_dp.dynamics_pallas_offline(
        params, jnp.asarray(SIGNALS[signal]), segments=5, interpret=True))


# ---------------------------------------------------------------------------
# factories


@pytest.mark.parametrize("name", OPS)
def test_factory_params_equal_jax(name):
    je, pe = _jx(name), _pt(name)
    assert pe.name == je.name and pe.time_parallel is False
    jp, pp = je.params, pe.params
    assert (pp.x_max, pp.y_max) == (jp.x_max, jp.y_max)
    assert type(pp).meta_fields == ("x_max", "y_max")
    for field in ("threshold", "pre_gain", "attack_env", "release_env"):
        want = np.asarray(getattr(jp, field))
        got = getattr(pp, field)
        assert got.dtype == torch.float32 and got.device.type == "cpu", field
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    if name == "short_attack":
        assert pp.x_max == 1 and float(pp.attack_env[-1]) == 1.0 \
            and float(pp.release_env[0]) == 0.5


@pytest.mark.parametrize("name", OPS)
def test_kernel_scalars_equal_jax(name):
    """The eight scalars the walks take by value, bit for bit those the JAX
    kernels read from SMEM."""
    jp = _jx(name).params
    want_f = np.asarray(jx_dp._pack_fscal(jp)).reshape(6)
    sc = kd.op_scalars(_pt(name).params)
    assert all(isinstance(v, np.float32) for v in sc[:6])
    np.testing.assert_array_equal(np.array(sc[:6], np.float32), want_f)
    assert sc[6:] == (jp.x_max, jp.x_max + jp.y_max)


def test_encode_state_matches_jax():
    rng = np.random.default_rng(5)
    pp, jp = _pt("chain8_gate").params, _jx("chain8_gate").params
    n = 4000
    mode = rng.integers(0, 4, n).astype(np.int32)
    # legal states: x counts in ATTACK (1..x_max-1) and is x_max in HOLD, y
    # counts in RELEASE (1..y_max-1); skip only ever accompanies REST
    x = np.where(mode == 1, rng.integers(1, pp.x_max, n),
                 np.where(mode == 2, pp.x_max, 0)).astype(np.int32)
    y = np.where(mode == 3, rng.integers(1, pp.y_max, n), 0).astype(np.int32)
    skip = (mode == 0) & (rng.random(n) < 0.3)
    want = np.asarray(jx_dp.encode_state(jp, {
        "mode": jnp.asarray(mode), "x": jnp.asarray(x), "y": jnp.asarray(y),
        "skip": jnp.asarray(skip)}))
    got = kd.encode_state(pp, {
        "mode": torch.from_numpy(mode), "x": torch.from_numpy(x),
        "y": torch.from_numpy(y), "skip": torch.from_numpy(skip)})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # every kind of state was drawn: skip, REST, ATTACK, HOLD, RELEASE
    assert {-1, 0, 1, pp.x_max} <= set(want.tolist()) \
        and want.max() > pp.x_max


# ---------------------------------------------------------------------------
# the faithful step


@pytest.mark.parametrize("name", ["chain8_compressor", "chain8_gate",
                                  "short_attack"])
def test_faithful_step_matches_jax_step(name):
    """Several blocks with the state carried. Both sides gather the same
    float32 table and multiply block * pre_gain * gain in the same order, so
    the state is exactly equal and the audio is bit-equal (the bar asked for
    is 120 dB; equality is what is asserted)."""
    je, pe = _jx(name), _pt(name)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 700)) * 0.3
         * (rng.random((3, 5, 700)) > 0.4)).astype(np.float32)
    x[:, 2] *= 0.001                       # a quiet block: releases complete
    jst = je.init_state(je.params, (3,))
    pst = pe.state((3,))
    assert all(v.shape == (3,) for v in pst.values())
    for b in range(x.shape[1]):
        jst, want = je.step(je.params, jst, jnp.asarray(x[:, b]))
        pst, got = pt_dyn.step_faithful(pe.params, pst,
                                        torch.from_numpy(x[:, b]))
        assert got.dtype == torch.float32
        assert snr_db(np.asarray(want), got.numpy()) >= 120.0
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for k in ("mode", "x", "y", "skip"):
            np.testing.assert_array_equal(pst[k].numpy(), np.asarray(jst[k]),
                                          err_msg=f"{k} after block {b}")
    assert pst["mode"].dtype == torch.int32 and pst["skip"].dtype == torch.bool


def test_fused_dynamics_step_folds_the_faithful_steps():
    """One cascade walk per block is bit-equal to the members' own steps one
    after the other (op j+1 reads op j's output sample either way), and as
    close to the faithful table-driven steps as the arithmetic ramps allow."""
    comp, gate = _pt("chain8_compressor"), _pt("chain8_gate")
    fused = kd.fused_dynamics([comp, gate])
    assert fused.name == "dynamics_cascade:compressor+gate"
    assert fused.time_parallel is False and fused.device.type == "cpu"
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal((2, 1500)) * 0.4
                          ).astype(np.float32))
    st = fused.state((2,))
    st, out = fused.step(fused.params, st, x)
    _, mid = comp.step(comp.params, comp.state((2,)), x)
    st2, want = gate.step(gate.params, gate.state((2,)), mid)
    assert torch.equal(out, want)
    for k in ("mode", "x", "y", "skip"):
        assert torch.equal(st[1][k], st2[k]), k
    _, f_mid = pt_dyn.step_faithful(comp.params, comp.state((2,)), x)
    f_st, f_want = pt_dyn.step_faithful(gate.params, gate.state((2,)), f_mid)
    assert snr_db(f_want.numpy(), out.numpy()) > 100.0


# ---------------------------------------------------------------------------
# the speculative walks


@pytest.mark.parametrize("segments", [1, 5, 16])
@pytest.mark.parametrize("cascade", CASCADES)
def test_offline_bit_equal_across_segmentations_and_close_to_jax(cascade,
                                                                 segments):
    """The fixpoint is the serial trajectory, so every segmentation is
    BIT-equal to the one-segment walk. Against the JAX faithful scans the
    bar is the JAX package's own, > 100 dB: the walks compute the ramps
    arithmetically, within 2 ulp of the scans' float32 tables. The same bar
    holds against the JAX kernel in interpret mode (same arithmetic; XLA on
    the CPU may contract a multiply-add that PyTorch keeps apart)."""
    params = [_pt(n).params for n in CASCADES[cascade]]
    for signal, x in SIGNALS.items():
        got = kd.dynamics_offline(params if len(params) > 1 else params[0],
                                  torch.from_numpy(x), segments=segments)
        assert got.dtype == torch.float32 and got.shape == x.shape
        assert torch.equal(got, _serial(cascade, signal)), (signal, segments)
        assert snr_db(_jax_scan_fold(cascade, signal), got.numpy()) > 100.0, \
            (signal, segments)
        assert snr_db(_jax_kernel(cascade, signal), got.numpy()) > 100.0, \
            (signal, segments)


@pytest.mark.parametrize("C", [1, 3, 64])
def test_offline_ragged_length_and_channel_counts(C):
    """T is no multiple of the segment length: the last segment is ragged,
    its zero rows are walked and its exit state is dropped."""
    T = 5037
    rng = np.random.default_rng(C)
    x = (rng.standard_normal((C, T)) * 0.3
         * (rng.random((C, T)) > 0.5)).astype(np.float32)
    params = [_pt(n).params for n in CASCADES["cascade"]]
    xt = torch.from_numpy(x)
    serial = kd.dynamics_offline(params, xt, segments=1)
    G, L, _ = rl.geometry(C, T, 7)
    assert G * L != T
    assert torch.equal(kd.dynamics_offline(params, xt, segments=7), serial)
    assert torch.equal(kd.dynamics_offline(params, xt), serial)   # planner
    y = jnp.asarray(x)
    for n in CASCADES["cascade"]:
        e = _jx(n)
        _, y = e.step(e.params, e.init_state(e.params, (C,)), y)
    assert snr_db(np.asarray(y), serial.numpy()) > 100.0


def test_offline_short_attack_edge():
    """x_max == 1: the hold gain is attack_env[0] == 1.0 while the release
    ramp still starts at the ratio; both scalars are carried apart."""
    je, pe = _jx("short_attack"), _pt("short_attack")
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((1, 8000)) * 0.5).astype(np.float32)
    _, want = je.step(je.params, je.init_state(je.params, (1,)),
                      jnp.asarray(x))
    xt = torch.from_numpy(x)
    got = kd.dynamics_offline(pe.params, xt, segments=7)
    assert torch.equal(got, kd.dynamics_offline(pe.params, xt, segments=1))
    assert snr_db(np.asarray(want), got.numpy()) > 100.0


def _gap_signal():
    """A loud level with silent gaps one sample shorter than, as long as and
    one sample longer than the releases of the ops below (88 and 132)."""
    pieces = []
    for gap in (87, 88, 89, 131, 132, 133, 300):
        pieces += [np.full(300, 0.5, np.float32), np.zeros(gap, np.float32)]
    row = np.concatenate(pieces + [np.full(300, 0.5, np.float32)])
    return np.stack([row, -row])


def test_skip_sample_after_a_completed_release():
    """A release that completes on the last silent sample makes the next
    sample a SKIPPED one (gain 1, not examined) and the trigger comes one
    sample later. The other signals hardly ever put a loud sample right
    after a completed release; this one does, for both ops of a cascade."""
    jeffs = [jx.ops.compressor(JCFG, -20.0, 0.5, 3.1, 2.0),
             jx.ops.gate(JCFG, -45.0, 0.1, 3.1, 3.0)]
    peffs = [pt.ops.compressor(PCFG, -20.0, 0.5, 3.1, 2.0, device=CPU),
             pt.ops.gate(PCFG, -45.0, 0.1, 3.1, 3.0, device=CPU)]
    assert [e.params.y_max for e in peffs] == [88, 132]
    x = _gap_signal()
    xt = torch.from_numpy(x)
    comp = peffs[0].params
    alone = kd.dynamics_offline(comp, xt, segments=1)
    after_87 = 300 + 87              # re-trigger out of RELEASE: hold gain
    after_88 = after_87 + 300 + 88   # release completed: this one is skipped
    assert alone[0, after_87] == 0.25
    assert alone[0, after_88] == 0.5 and alone[0, after_88 + 1] == 0.5
    assert alone[0, after_88 + 2] < 0.5          # the attack ramp, one late
    params = [e.params for e in peffs]
    serial = kd.dynamics_offline(params, xt, segments=1)
    for segments in (5, 16):
        assert torch.equal(kd.dynamics_offline(params, xt, segments=segments),
                           serial)
    y = jnp.asarray(x)
    for e in jeffs:
        _, y = e.step(e.params, e.init_state(e.params, (2,)), y)
    assert snr_db(np.asarray(y), serial.numpy()) > 100.0
    scalars = [kd.op_scalars(p) for p in params]
    np.testing.assert_array_equal(
        emulate_walk(scalars, x[0], [0, 0])[0], serial[0].numpy())


@pytest.mark.parametrize("signal", SIGNALS)
def test_scalar_mirror_of_the_cuda_walk_is_bit_equal(signal):
    """One lane walked by ``emulate_walk`` (branches, one rounded float32
    operation at a time, as csrc/dynamics.cu runs it) against the plain
    tensor walk: audio and exit states, audio walk and state walk, from REST
    and from a mid-release entry."""
    scalars = [kd.op_scalars(_pt(n).params) for n in CASCADES["cascade"]]
    x = SIGNALS[signal][:1, :4000]
    xt = torch.from_numpy(np.ascontiguousarray(x))      # one segment of 4000
    for entry in ([0, 0], [scalars[0][6] + 40, scalars[1][6] + 3000],
                  [5, -1]):
        e = torch.tensor(entry, dtype=torch.int32).reshape(2, 1)
        out, z = kd.audio_walk(scalars, xt, 1, 4000, e)
        m_out, m_z = emulate_walk(scalars, x[0], entry, audio=True)
        np.testing.assert_array_equal(out[0].numpy(), m_out)
        assert z[:, 0].tolist() == m_z
        zs = kd.state_walk(scalars, xt, 1, 4000, e)
        assert zs[:, 0].tolist() == emulate_walk(scalars, x[0], entry,
                                                 audio=False)[1] == m_z


def test_loop_walks_until_the_entries_settle(monkeypatch):
    """On the decay signal at 16 segments of 750 samples the gate's release
    crosses a dozen segments: the loop takes one walk per segment crossed
    and never more than G + 2, and the result is still the serial one
    (asserted for every signal in the test above)."""
    walks = []
    plain = kd.walk_plain
    monkeypatch.setattr(kd, "walk_plain",
                        lambda *a, **k: walks.append(k["audio"]) or plain(*a, **k))
    params = [_pt(n).params for n in CASCADES["cascade"]]
    got = kd.dynamics_offline(params, torch.from_numpy(SIGNALS["decay"]),
                              segments=16)
    assert walks[0] is False and all(walks[1:])     # one state walk, first
    assert 8 <= len(walks) <= 16 + 2
    assert torch.equal(got, _serial("cascade", "decay"))
    walks.clear()
    kd.dynamics_offline(params, torch.from_numpy(SIGNALS["bursty"]),
                        segments=16)
    assert walks == [False, True]


def test_state_walk_equals_audio_walks_exit_states():
    scalars = [kd.op_scalars(_pt(n).params) for n in CASCADES["cascade"]]
    T = N - 3
    x = torch.from_numpy(np.ascontiguousarray(SIGNALS["bursty"][:, :T]))
    G, L, _ = rl.geometry(2, T, 5)
    assert G * L > T
    e = torch.zeros((2, 2 * G), dtype=torch.int32)
    out, z = kd.audio_walk(scalars, x, G, L, e)
    assert out.shape == (2, T)
    assert torch.equal(kd.state_walk(scalars, x, G, L, e), z)
    # the ragged last segment walks zeros past T, as the time-major copy's
    # zero pad does
    tm = rl.pack(x, G, L, 2 * G)
    want_out, want_z = kd.walk_plain(scalars, tm, e, audio=True)
    assert torch.equal(z, want_z)
    assert torch.equal(out, rl.unpack(want_out, 2, T, G, L))


# ---------------------------------------------------------------------------
# effects, planner, refusals


def test_lone_effect_offline_takes_the_walks_and_no_kernel_on_cpu():
    comp = _pt("chain8_compressor")
    before = (kd.state_walk_launch_count, kd.audio_walk_launch_count,
              rl.pack_launch_count, rl.unpack_launch_count)
    x = torch.from_numpy(SIGNALS["bursty"][:, :6000])
    blocks = x.reshape(2, 12, 500)
    got = comp.offline(comp.params, blocks)
    assert got.shape == blocks.shape
    assert torch.equal(got.reshape(2, -1),
                       kd.dynamics_offline(comp.params, x, segments=1))
    # mono (nb, B) blocks are one channel
    mono = comp.offline(comp.params, blocks[0])
    assert torch.equal(mono, got[0])
    assert torch.equal(comp.offline(comp.params, blocks, use_kernels=False),
                       got)
    assert before == (kd.state_walk_launch_count, kd.audio_walk_launch_count,
                      rl.pack_launch_count, rl.unpack_launch_count)


def test_fused_dynamics_offline_equals_the_cascade_walk():
    fused = kd.fused_dynamics([_pt(n) for n in CASCADES["cascade"]])
    x = SIGNALS["bursty"]
    got = fused.offline(fused.params, torch.from_numpy(x).reshape(2, -1, 500))
    assert torch.equal(got.reshape(2, -1), _serial("cascade", "bursty"))


def test_planner_and_geometry():
    assert kd.plan_segments(64, 1323008) * 64 <= kd.TARGET_LANES
    assert 1323008 // kd.plan_segments(64, 1323008) >= kd.MIN_SEGMENT
    assert kd.plan_segments(2, 100) == 1
    assert kd.plan_segments(1, 10 * kd.MIN_SEGMENT) == 10
    G, L, Rp = rl.geometry(3, 1000, 7)
    assert (G, L) == (7, 143) and Rp == 32 and (G - 1) * L < 1000 <= G * L
    # a request for more segments than samples gives one sample a segment
    assert rl.geometry(1, 5, 9)[:2] == (5, 1)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    sc = [kd.op_scalars(_pt("chain8_gate").params)]
    x = torch.zeros((2, 10))
    e = torch.zeros((1, 4), dtype=torch.int32)            # G = 2, L = 5
    with pytest.raises(ValueError, match="float32"):
        kd.audio_walk(sc, x.double(), 2, 5, e)
    with pytest.raises(ValueError, match="contiguous"):
        kd.state_walk(sc, torch.zeros((10, 2)).T, 2, 5, e)
    with pytest.raises(ValueError, match="int32"):
        kd.state_walk(sc, x, 2, 5, e.long())
    with pytest.raises(ValueError, match="entry states"):
        kd.audio_walk(sc * 2, x, 2, 5, e)
    with pytest.raises(ValueError, match="do not tile"):
        kd.audio_walk(sc, x, 2, 4, e)
    with pytest.raises(ValueError, match="1 to 4"):
        kd.dynamics_offline([_pt("chain8_gate").params] * 5,
                            torch.zeros((1, 100)))
    with pytest.raises(ValueError, match=r"\(C, T\)"):
        kd.dynamics_offline(_pt("chain8_gate").params, torch.zeros(100))


# ---------------------------------------------------------------------------
# the serial walk: the streaming step


def _burst(C, n, seed=3):
    """The signal of the JAX package's kernel tests (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((C, n)) * 0.02).astype(np.float32)
    for start in range(0, n, 3000):
        w = min(700, n - start)
        x[:, start:start + w] += (rng.standard_normal((C, w)) * 0.7
                                  ).astype(np.float32)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _legal_states(params, n, rng):
    """n random states of every kind the automaton can be in."""
    mode = rng.integers(0, 4, n).astype(np.int32)
    if params.x_max == 1:
        mode[mode == 1] = 2              # no ATTACK state when x_max == 1
    x = np.where(mode == 1, rng.integers(1, max(params.x_max, 2), n),
                 np.where(mode == 2, params.x_max, 0)).astype(np.int32)
    y = np.where(mode == 3, rng.integers(1, params.y_max, n), 0
                 ).astype(np.int32)
    skip = (mode == 0) & (rng.random(n) < 0.3)
    return {"mode": mode, "x": x, "y": y, "skip": skip}


def _max_ulp(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 representation steps."""
    def key(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(a) - key(b)).max()) if a.size else 0


@pytest.mark.parametrize("name", OPS)
def test_decode_state_inverts_encode_state(name):
    """decode(encode(s)) == s field by field for every state the automaton
    can return: REST, ATTACK with x in 1..x_max-1, HOLD with x = x_max,
    RELEASE with x = 0 and y in 1..y_max-1, and the skipped sample."""
    p = _pt(name).params
    rng = np.random.default_rng(23)
    s = _legal_states(p, 5000, rng)
    # and every boundary value by hand
    edge = {"mode": [0, 0, 2, 3, 3] + ([1, 1] if p.x_max > 1 else []),
            "x": [0, 0, p.x_max, 0, 0] + ([1, p.x_max - 1] if p.x_max > 1
                                          else []),
            "y": [0, 0, 0, 1, p.y_max - 1] + ([0, 0] if p.x_max > 1 else []),
            "skip": [False, True, False, False, False]
                    + ([False, False] if p.x_max > 1 else [])}
    state = {k: torch.from_numpy(np.concatenate(
        [s[k], np.asarray(edge[k], s[k].dtype)])) for k in s}
    code = kd.encode_state(p, state)
    assert int(code.min()) == -1 and int(code.max()) == p.x_max + p.y_max - 1
    back = kd.decode_state(p, code)
    for k in ("mode", "x", "y", "skip"):
        assert back[k].dtype == state[k].dtype, k
        assert torch.equal(back[k], state[k]), k
    # ... and encode(decode(c)) == c for every code there is
    codes = torch.arange(-1, p.x_max + p.y_max, dtype=torch.int32)
    assert torch.equal(kd.encode_state(p, kd.decode_state(p, codes)), codes)


@pytest.mark.parametrize("name", ["chain8_compressor", "chain8_gate",
                                  "short_attack"])
def test_serial_walk_plain_matches_jax_serial_kernel(name, capsys):
    """The plain serial walk against ``dynamics_pallas(..., interpret=True)``
    on one (C, T) block, from REST and from random legal states: the state
    fields are equal, and the audio is within the bar the JAX package holds
    its kernel to (> 100 dB). Both compute the ramps arithmetically; XLA on
    the CPU may contract a multiply-add that PyTorch keeps apart, so the
    audio need not be bit-equal: the largest difference is printed."""
    je, pe = _jx(name), _pt(name)
    C, T = 4, 1500
    x = _burst(C, T, seed=5)
    rng = np.random.default_rng(29)
    scalars = [kd.op_scalars(pe.params)]
    for label, st in (("rest", {k: np.zeros(C, d) for k, d in (
            ("mode", np.int32), ("x", np.int32), ("y", np.int32),
            ("skip", bool))}), ("random", _legal_states(pe.params, C, rng))):
        jst, want = jx_dp.dynamics_pallas(
            je.params, {k: jnp.asarray(v) for k, v in st.items()},
            jnp.asarray(x), t_tile=1024, interpret=True)
        entry = kd.encode_state(
            pe.params, {k: torch.from_numpy(v) for k, v in st.items()}
        ).reshape(1, C)
        out, exit_state = kd.serial_walk(scalars, torch.from_numpy(x), entry)
        assert out.shape == (C, T) and out.dtype == torch.float32
        got = kd.decode_state(pe.params, exit_state[0])
        for k in ("mode", "x", "y", "skip"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(jst[k]),
                                          err_msg=f"{label}: {k}")
        assert snr_db(np.asarray(want), out.numpy()) > 100.0, label
        with capsys.disabled():
            print(f"\n  serial walk vs dynamics_pallas [{name}, {label}]: "
                  f"largest difference {_max_ulp(np.asarray(want), out.numpy())}"
                  " ulp")
        # one lane, the way a CUDA thread walks it
        m_out, m_z = emulate_walk(scalars, x[1], [int(entry[0, 1])])
        np.testing.assert_array_equal(out[1].numpy(), m_out)
        assert [int(exit_state[0, 1])] == m_z


@pytest.mark.parametrize("factory,args,B", [
    ("compressor", (), 512), ("gate", (), 512),
    ("compressor", (-18.0, 0.6), 1500),   # longer than, and no multiple of,
])                                        # the TPU kernel's time tile
def test_step_carries_state_like_the_jax_kernel_and_scan(factory, args, B):
    """The three cases of the JAX package's kernel tests: six blocks through
    the port's ``step`` (the serial walk), the JAX kernel-backed step in
    interpret mode and the JAX faithful scan, the state carried. State
    fields equal after every block, audio > 100 dB."""
    jcfg, pcfg = jx.EngineConfig(44100, B), pt.EngineConfig(44100, B)
    base = getattr(jx.ops, factory)(jcfg, *args)
    fast = jx_dp.fast_effect(base, interpret=True)
    pe = getattr(pt.ops, factory)(pcfg, *args, device=CPU)
    x = _burst(2, B * 6, seed=9 if B == 512 else 13).reshape(2, 6, B)
    b_state = base.init_state(base.params, (2,))
    f_state = fast.init_state(fast.params, (2,))
    p_state = pe.state((2,))
    before = kd.serial_walk_launch_count
    for i in range(6):
        b_state, b_out = base.step(base.params, b_state, jnp.asarray(x[:, i]))
        f_state, f_out = fast.step(fast.params, f_state, jnp.asarray(x[:, i]))
        p_state, p_out = pe.step(pe.params, p_state,
                                 torch.from_numpy(x[:, i]))
        assert snr_db(np.asarray(b_out), p_out.numpy()) > 100.0
        assert snr_db(np.asarray(f_out), p_out.numpy()) > 100.0
        for k in ("mode", "x", "y", "skip"):
            np.testing.assert_array_equal(p_state[k].numpy(),
                                          np.asarray(b_state[k]),
                                          err_msg=f"{k} after block {i}")
            np.testing.assert_array_equal(p_state[k].numpy(),
                                          np.asarray(f_state[k]),
                                          err_msg=f"{k} after block {i}")
    assert kd.serial_walk_launch_count == before     # no kernel on the CPU


def test_step_short_attack_edge():
    """x_max == 1 through the step: the hold gain is 1.0, the release ramp
    starts at the ratio; six blocks against the JAX scan and its kernel."""
    je, pe = _jx("short_attack"), _pt("short_attack")
    fast = jx_dp.fast_effect(je, interpret=True)
    x = _burst(2, 512 * 6, seed=17).reshape(2, 6, 512)
    jst = je.init_state(je.params, (2,))
    fst = fast.init_state(fast.params, (2,))
    pst = pe.state((2,))
    fst_p = pe.state((2,))
    for i in range(6):
        jst, want = je.step(je.params, jst, jnp.asarray(x[:, i]))
        fst, f_out = fast.step(fast.params, fst, jnp.asarray(x[:, i]))
        pst, got = pe.step(pe.params, pst, torch.from_numpy(x[:, i]))
        fst_p, f_got = pt_dyn.step_faithful(pe.params, fst_p,
                                            torch.from_numpy(x[:, i]))
        assert snr_db(np.asarray(want), got.numpy()) > 100.0
        assert snr_db(np.asarray(f_out), got.numpy()) > 100.0
        np.testing.assert_array_equal(f_got.numpy(), np.asarray(want))
        for k in ("mode", "x", "y", "skip"):
            np.testing.assert_array_equal(pst[k].numpy(), np.asarray(jst[k]))
            np.testing.assert_array_equal(pst[k].numpy(), fst_p[k].numpy())
    assert int((pst["mode"] == 1).sum()) == 0        # ATTACK never held


def test_cascade_step_bit_equal_to_op_after_op_steps():
    """One launch for the cascade gives what the JAX package's op-after-op
    loop gives: a cascade of three over five blocks (mono and batched)
    against the members' own steps, bit for bit, states included; and the
    streamed fold equals the offline walk of the whole signal."""
    members = [_pt("chain8_gate"), _pt("short_attack"),
               _pt("chain8_compressor")]
    fused = kd.fused_dynamics(members)
    x = torch.from_numpy(_burst(3, 700 * 5, seed=21).reshape(3, 5, 700))
    for blocks, batch in ((x, (3,)), (x[0], ())):
        st = fused.state(batch)
        own = [e.state(batch) for e in members]
        outs = []
        for i in range(5):
            blk = blocks[..., i, :]
            st, out = fused.step(fused.params, st, blk)
            want = blk
            for j, e in enumerate(members):
                own[j], want = e.step(e.params, own[j], want)
            assert torch.equal(out, want), i
            for j in range(3):
                for k in ("mode", "x", "y", "skip"):
                    assert st[j][k].shape == batch
                    assert torch.equal(st[j][k], own[j][k]), (i, j, k)
            outs.append(out)
        whole = kd.dynamics_offline([e.params for e in members],
                                    blocks.reshape(-1, 3500), segments=1)
        assert torch.equal(torch.stack(outs, dim=-2).reshape(-1, 3500), whole)


def test_serial_walk_refuses_what_its_kernel_does_not_take():
    sc = [kd.op_scalars(_pt("chain8_gate").params)]
    x = torch.zeros((3, 40))
    e = torch.zeros((1, 3), dtype=torch.int32)
    out, z = kd.serial_walk(sc, x, e)
    assert out.shape == (3, 40) and z.shape == (1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kd.serial_walk(sc, torch.zeros((40, 3)).T, e)
    with pytest.raises(ValueError, match="float32"):
        kd.serial_walk(sc, x.double(), e)
    with pytest.raises(ValueError, match="entry states"):
        kd.serial_walk(sc, x, torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="1 to 4"):
        kd.serial_walk(sc * 5, x, torch.zeros((5, 3), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the serial walk kernel's schedule (csrc/dynamics.cu), mirrored in numpy


SCHEDULE_CASCADES = {
    **CASCADES,
    "cascade_of_4": ("chain8_gate", "short_attack", "chain8_compressor",
                     "chain8_gate"),
}


def _scalars(cascade):
    return [kd.op_scalars(_pt(n).params) for n in SCHEDULE_CASCADES[cascade]]


def _schedule_input(cascade, T, entries):
    """(x (2, T), entry (n_ops, 2)): bursts with a quiet floor, so that the
    ops trigger, hold, release and rest inside a block; entries REST or
    random legal states."""
    scalars = _scalars(cascade)
    x = _burst(2, max(T, 8), seed=T)[:, :T]
    if entries == "rest":
        entry = np.zeros((len(scalars), 2), np.int32)
    else:
        rng = np.random.default_rng(T + len(scalars))
        entry = np.stack([rng.integers(-1, sc[7], 2) for sc in scalars]
                         ).astype(np.int32)
    return np.ascontiguousarray(x), entry


@functools.lru_cache(maxsize=None)
def _plain_serial(cascade, T, entries):
    x, entry = _schedule_input(cascade, T, entries)
    out, z = kd.serial_walk_plain(_scalars(cascade), torch.from_numpy(x),
                                  torch.from_numpy(entry))
    return out.numpy(), z.numpy()


def _lseg_for(T, G):
    """The smallest power-of-two segment with which G segments cover T."""
    lseg = 0
    while G << lseg < T:
        lseg += 1
    return lseg


@pytest.mark.parametrize("entries", ["rest", "random"])
@pytest.mark.parametrize("G", [1, 2, 16, 64])
@pytest.mark.parametrize("T", [1, 7, 512, 1500, 4096])
@pytest.mark.parametrize("cascade", SCHEDULE_CASCADES)
def test_serial_schedule_mirror_equals_plain(cascade, T, G, entries):
    """The kernel's schedule (segments, closed-form first guess, fixpoint
    rounds with the jump over quiet segments) gives the serial trajectory:
    samples and exit states EQUAL to ``serial_walk_plain`` whatever the
    segmentation, within G rounds."""
    scalars = _scalars(cascade)
    x, entry = _schedule_input(cascade, T, entries)
    want_out, want_z = _plain_serial(cascade, T, entries)
    lseg = _lseg_for(T, G)
    for c in range(x.shape[0]):
        out, z, rounds = emulate_serial_walk(scalars, x[c], entry[:, c],
                                             lseg, G)
        np.testing.assert_array_equal(out, want_out[c])
        assert z == want_z[:, c].tolist()
        assert 1 <= rounds <= max(G, 1)


@pytest.mark.parametrize("cascade", SCHEDULE_CASCADES)
def test_serial_schedule_mirror_walks_tile_after_tile(cascade):
    """A block longer than a tile (4 segments of 32 here) is walked tile
    after tile, each from the exit of the one before; a wrong first guess
    (off by one sample) costs rounds and nothing else."""
    scalars = _scalars(cascade)
    x, entry = _schedule_input(cascade, 1500, "random")
    want_out, want_z = _plain_serial(cascade, 1500, "random")
    tiles = -(-1500 // 128)
    for offset in (0, 1):
        out, z, rounds = emulate_serial_walk(scalars, x[0], entry[:, 0], 5, 4,
                                             guess_offset=offset)
        np.testing.assert_array_equal(out, want_out[0])
        assert z == want_z[:, 0].tolist()
        assert tiles <= rounds <= 4 * tiles


def _rounds_signals(T):
    """Entry kinds and signals whose rounds are bounded below: a carried
    RELEASE in pure silence; a burst in an earlier block then silence (the
    carried state is HOLD); a sound that dies away inside the block; the
    alternating signal of the JAX package's tests/test_fusion.py."""
    decay = np.zeros(T, np.float32)
    decay[:T // 8] = 0.5
    return {
        "silence_from_release": (np.zeros(T, np.float32), "release"),
        "silence_from_hold": (np.zeros(T, np.float32), "hold"),
        "dies_away_inside_the_block": (decay, "rest"),
        "alternating": (np.tile([0.9, 1e-4], T // 2).astype(np.float32),
                        "rest"),
    }


@pytest.mark.parametrize("T,lseg", [(512, 4), (4096, 6)])
@pytest.mark.parametrize("signal", list(_rounds_signals(8)))
def test_serial_schedule_round_counts(signal, T, lseg):
    """Rounds of the flagship cascade at the step's two geometries. In
    silence the closed-form guess is exact: ONE round (every round walks
    with audio, so none follows the loop), also where the gate's release
    (8,824 samples) outlasts the block. A sound that dies away inside the
    block settles its quiet stretch at once. The alternating signal hands
    the attack (136 samples, mask ignored) on a segment a round: 136 / L + 2
    rounds. Never more than one round a segment."""
    scalars = _scalars("cascade")
    G = T >> lseg
    x, kind = _rounds_signals(T)[signal]
    entry = {"rest": [0, 0],
             "hold": [sc[6] for sc in scalars],
             "release": [sc[6] + 5 for sc in scalars]}[kind]
    out, z, rounds = emulate_serial_walk(scalars, x, entry, lseg, G)
    w_out, w_z = emulate_walk(scalars, x, entry)
    np.testing.assert_array_equal(out, w_out)
    assert z == w_z
    assert rounds <= G
    if signal.startswith("silence"):
        assert rounds == 1
        assert z[1] > scalars[1][6]          # the gate is still releasing
    elif signal == "dies_away_inside_the_block":
        assert rounds <= 136 // (1 << lseg) + 4
    else:
        assert rounds <= 136 // (1 << lseg) + 3


@pytest.mark.parametrize("T,lseg", [(512, 4), (4096, 5)])
def test_serial_schedule_jumps_quiet_segments_in_few_rounds(T, lseg):
    """The jump over quiet segments: where a sound dies away inside the
    block the quiet stretch after it settles at once, a handful of rounds
    and not one a segment; in silence after a burst one round. The samples
    and states are the plain walk's."""
    scalars = _scalars("cascade")
    G = T >> lseg
    signals = _rounds_signals(T)
    for signal, kind in (("dies_away_inside_the_block", "rest"),
                         ("silence_from_hold", "hold")):
        x = signals[signal][0]
        entry = [0, 0] if kind == "rest" else [sc[6] for sc in scalars]
        out, z, rounds = emulate_serial_walk(scalars, x, entry, lseg, G)
        w_out, w_z = emulate_walk(scalars, x, entry)
        np.testing.assert_array_equal(out, w_out)
        assert z == w_z
        if kind == "hold":
            assert rounds == 1
        else:
            assert rounds <= 136 // (1 << lseg) + 4


@pytest.mark.parametrize("name", OPS)
def test_closed_form_guess_is_a_walk_over_silence(name):
    """The first guess, for EVERY encoded entry of an op: a legal state, and
    equal to a real walk over that many zero samples."""
    sc = kd.op_scalars(_pt(name).params)
    end = sc[7]
    # ONE real walk over silence from state 1 passes through every state
    # 1, 2, .. end-1, then skip, then REST: the automaton is deterministic,
    # so the walk from state s is that walk from where it passes s.
    trail, state = [1], [1]
    for _ in range(end + 64 + sc[6] + 2):
        _, state = emulate_walk([sc], np.zeros(1, np.float32), state)
        trail.append(state[0])
    assert trail[:end + 2] == list(range(1, end)) + [-1, 0, 0]
    start = {s: s - 1 for s in range(1, end)}
    start[-1], start[0] = end - 1, end
    for s in range(-1, end):
        for d in (0, 1, 2, 16, 64, sc[6], end - s, end - s - 1, end - s + 1):
            if not 0 <= d <= 64 + sc[6]:
                continue
            got = advance_quiet(sc, s, d)
            assert -1 <= got < end
            assert got == trail[start[s] + d], (s, d)


def test_cascade_step_state_tree_survives_a_checkpoint(tmp_path):
    """The state's tree, leaf shapes and dtypes are what they were before
    the step moved into the kernel: a state written leaf by leaf the way an
    earlier checkpoint holds it (int32 mode, x, y and bool skip per op, in
    ``state_leaves`` order) loads into today's tree, steps, saves and loads
    again with the same leaves in the same order."""
    from pyaudiodsptools_tpu_torch.engine.stream import (load_state_npz,
                                                         save_state_npz,
                                                         state_leaves,
                                                         state_paths)
    members = [_pt("chain8_compressor"), _pt("chain8_gate")]
    fused = kd.fused_dynamics(members)
    template = fused.state((3,))
    assert [path for path, _ in state_paths(template)] == [
        (j, k) for j in range(2) for k in ("mode", "skip", "x", "y")]
    rng = np.random.default_rng(37)
    legal = [_legal_states(e.params, 3, rng) for e in members]
    old = str(tmp_path / "earlier.npz")
    np.savez(old, *[legal[j][k] for j in range(2)
                    for k in ("mode", "skip", "x", "y")])
    state = load_state_npz(old, template)
    for j in range(2):
        for k in ("mode", "x", "y", "skip"):
            assert state[j][k].dtype == template[j][k].dtype
            np.testing.assert_array_equal(state[j][k].numpy(), legal[j][k])
    x = torch.from_numpy(_burst(3, 700, seed=41))
    new_state, out = fused.step(fused.params, state, x)
    new = str(tmp_path / "new.npz")
    save_state_npz(new, new_state)
    back = load_state_npz(new, template)
    with np.load(old) as a, np.load(new) as b:
        assert a.files == b.files
        for name in a.files:
            assert a[name].shape == b[name].shape
            assert a[name].dtype == b[name].dtype
    for got, want in zip(state_leaves(back), state_leaves(new_state)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    again, out2 = fused.step(fused.params, back, x)
    again_direct, out3 = fused.step(fused.params, new_state, x)
    assert torch.equal(out2, out3)


@pytest.mark.cuda
@pytest.mark.parametrize("cascade", CASCADES)
def test_cuda_serial_walk_bit_equal_to_plain_on_card(cascade):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    plist = [_pt(n).params for n in CASCADES[cascade]]
    scalars = [kd.op_scalars(p) for p in plist]
    rng = np.random.default_rng(31)
    for signal, x in SIGNALS.items():
        xd = torch.from_numpy(np.ascontiguousarray(x[:, :1500])).cuda()
        entry = torch.from_numpy(np.stack(
            [rng.integers(-1, sc[7], 2) for sc in scalars]).astype(np.int32)
        ).cuda()
        before = kd.serial_walk_launch_count
        out, z = kd.serial_walk(scalars, xd, entry)
        torch.cuda.synchronize()
        assert kd.serial_walk_launch_count == before + 1
        p_out, p_z = kd.serial_walk(scalars, xd, entry, use_kernels=False)
        assert kd.serial_walk_launch_count == before + 1
        assert torch.equal(out, p_out) and torch.equal(z, p_z), signal


@pytest.mark.cuda
def test_cuda_step_carries_state_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    cfg = pt.EngineConfig(44100, 1500)
    card = pt.ops.compressor(cfg, -18.0, 0.6, device="cuda")
    host = pt.ops.compressor(cfg, -18.0, 0.6, device=CPU)
    x = _burst(2, 1500 * 6, seed=13).reshape(2, 6, 1500)
    cst, hst = card.state((2,)), host.state((2,))
    for i in range(6):
        cst, c_out = card.step(card.params, cst,
                               torch.from_numpy(x[:, i]).cuda())
        hst, h_out = host.step(host.params, hst, torch.from_numpy(x[:, i]))
        assert torch.equal(c_out.cpu(), h_out)
        for k in ("mode", "x", "y", "skip"):
            assert cst[k].is_cuda and torch.equal(cst[k].cpu(), hst[k])


@pytest.mark.cuda
@pytest.mark.parametrize("cascade", CASCADES)
def test_cuda_walks_bit_equal_to_plain_on_card(cascade):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    params = [_pt(n).params for n in CASCADES[cascade]]
    for signal, x in SIGNALS.items():
        xd = torch.from_numpy(x).cuda()
        before = (kd.state_walk_launch_count, kd.audio_walk_launch_count)
        got = kd.dynamics_offline(params, xd, segments=16)
        torch.cuda.synchronize()
        assert kd.state_walk_launch_count == before[0] + 1
        assert kd.audio_walk_launch_count > before[1]
        assert torch.equal(got.cpu(), _serial(cascade, signal)), signal
