"""PyTorch/CUDA port, ``profiling``: the annotated chain against the plain
unfused chain and the JAX package's ``profiling.annotate_chain``, and the
trace's scopes. chain8's effects at 2 channels x 16 blocks of 512, on the
CPU (the plain versions); the ``cuda`` cases repeat the bit-equality on the
card."""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyaudiodsptools_tpu as jx
import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu import profiling as jx_profiling
from pyaudiodsptools_tpu.core import block as jx_block
from pyaudiodsptools_tpu_torch import profiling

from torch_port_util import snr_db

B = 512
BLOCKS = 16
CHAIN8_NAMES = ["lowcut", "highcut", "eq3band_fft", "compressor", "gate",
                "delay", "tremolo", "softclipper"]


def _chain8_effects(cfg, device):
    """The flagship chain, with the arguments of ``__graft_entry__._chain8``."""
    o = pt.ops
    return [o.lowcut(cfg, 120.0, device=device),
            o.highcut(cfg, 12000.0, device=device),
            o.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5,
                          device=device),
            o.compressor(cfg, -18.0, 0.6, 3.1, 30.1, device=device),
            o.gate(cfg, -45.0, 0.1, 3.1, 200.1, device=device),
            o.delay(cfg, 150.0, 2, device=device),
            o.tremolo(cfg, 0.3, 5.0, device=device),
            o.softclipper(cfg, 0.44, device=device)]


def _signal(C=2, seed=9):
    rng = np.random.default_rng(seed)
    n = BLOCKS * B
    burst = (np.sin(2 * np.pi * np.arange(n) / 2048) > 0.3) * 0.6 + 0.2
    x = rng.standard_normal((C, n)) * 0.3 * burst
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _chains(device):
    cfg = pt.EngineConfig(44100, B)
    fused = pt.Chain(_chain8_effects(cfg, device), device=device)
    bare = pt.Chain(_chain8_effects(cfg, device), fuse=False, device=device)
    return cfg, fused, profiling.annotate_chain(fused), bare


def _steps(chain, x):
    state = chain.init_state((x.shape[0],))
    outs = []
    for i in range(BLOCKS):
        state, y = chain.step(state, x[:, i * B:(i + 1) * B])
        outs.append(y)
    return torch.cat(outs, dim=-1)


def test_annotated_chain_is_the_unfused_chain_bit_for_bit():
    cfg, fused, ann, bare = _chains("cpu")
    assert [e.name for e in ann.exec_effects] == CHAIN8_NAMES
    assert ann.device == torch.device("cpu")
    for a, e in zip(ann.exec_effects, fused.effects):
        assert a.params is e.params and a.lti_kernel is e.lti_kernel
        assert (a.reach, a.block_indexed, a.time_parallel, a.device) == \
            (e.reach, e.block_indexed, e.time_parallel, e.device)
    x = torch.from_numpy(_signal())
    torch.testing.assert_close(pt.render(ann, x, cfg), pt.render(bare, x, cfg),
                               rtol=0, atol=0)
    torch.testing.assert_close(_steps(ann, x), _steps(bare, x), rtol=0,
                               atol=0)


def test_annotated_chain_matches_jax_annotated_chain():
    from __graft_entry__ import _chain8

    jchain = jx_profiling.annotate_chain(_chain8(jx.EngineConfig(44100, B)))
    cfg, _, ann, _ = _chains("cpu")
    assert [e.name for e in jchain.exec_effects] == \
        [e.name for e in ann.exec_effects] == CHAIN8_NAMES
    x = _signal(seed=21)
    want = np.asarray(jx_block.combine_blocks(jchain.render_blocks(
        jx_block.make_blocks(jnp.asarray(x), B))))
    got = pt.render(ann, x, cfg).numpy()
    # the bar of the JAX package's kernel-backed chain against its faithful
    # path, as for the fused chain8 (tests/test_torch_chain.py)
    assert snr_db(want, got) >= 90.0


def test_trace_writes_every_scope(tmp_path):
    cfg, _, ann, _ = _chains("cpu")
    x = torch.from_numpy(_signal())
    with profiling.trace(str(tmp_path), device="cpu"):
        pt.render(ann, x, cfg)
        sp = pt.StreamProcessor(ann, cfg, (x.shape[0],))
        sp.process(x[:, :B])
    files = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {f"effect.{n}.{kind}" for n in CHAIN8_NAMES
            for kind in ("offline", "step")} <= names


def test_trace_on_the_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        with profiling.trace(str(tmp_path)):
            pass
    assert not os.listdir(tmp_path)


def test_annotated_tremolo_keeps_first_block():
    cfg = pt.EngineConfig(44100, B)
    bare = pt.ops.tremolo(cfg, 0.3, 5.0, device="cpu")
    (ann,) = profiling.annotate_chain(pt.Chain([bare], device="cpu")
                                      ).exec_effects
    assert ann.block_indexed
    blocks = torch.from_numpy(_signal(C=1)).reshape(1, BLOCKS, B)
    got = ann.offline(ann.params, blocks, use_kernels=False, first_block=5)
    want = bare.offline(bare.params, blocks, use_kernels=False,
                        first_block=5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, ann.offline(ann.params, blocks))


@pytest.mark.cuda
def test_annotated_chain_is_the_unfused_chain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg, _, ann, bare = _chains("cuda")
    x = torch.from_numpy(_signal(C=64)).cuda()
    assert torch.equal(pt.render(ann, x, cfg), pt.render(bare, x, cfg))
    assert torch.equal(_steps(ann, x), _steps(bare, x))


@pytest.mark.cuda
def test_trace_on_card_holds_kernels(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg, _, ann, _ = _chains("cuda")
    x = torch.from_numpy(_signal(C=64)).cuda()
    with profiling.trace(str(tmp_path)):
        pt.render(ann, x, cfg)
    (path,) = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("segconv_kernel" in k for k in kernels), kernels[:20]
    assert any("walk_kernel" in k for k in kernels), kernels[:20]


# ---------------------------------------------------------------------------
# the program's spans, the capture counter and the trace's reader


@pytest.fixture
def tracing_off():
    """Tracing off before and after, whatever the test left."""
    profiling.enable(False)
    yield
    profiling.enable(False)


def _cpu_chain():
    """A FIR, a delay and the soft clipper: the profiler records every
    op of a plain render, and the dynamics' plain walks are Python loops."""
    cfg = pt.EngineConfig(44100, B)
    o = pt.ops
    return cfg, pt.Chain([o.lowcut(cfg, 120.0, device="cpu"),
                          o.delay(cfg, 150.0, 2, device="cpu"),
                          o.softclipper(cfg, 0.44, device="cpu")],
                         device="cpu")


def _user_spans(prof) -> list[tuple[str, int, int]]:
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def test_span_is_the_shared_noop_when_tracing_is_off(tracing_off):
    from torch.profiler import ProfilerActivity, profile

    assert not profiling.enabled()
    assert profiling.span("render", 3) is profiling.span("step.copy_in")
    cfg, chain = _cpu_chain()
    x = _signal()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.span("step") is profiling.span("render")
        pt.render(chain, x, cfg)
        pt.StreamProcessor(chain, cfg, (2,)).process(x[:, :B])
    assert _user_spans(prof) == []
    # on, but no profiler recording: still the no-op
    profiling.enable()
    assert profiling.span("step", 1) is profiling.span("render")


def test_trace_turns_tracing_on_for_its_duration(tmp_path, tracing_off):
    with profiling.trace(str(tmp_path), device="cpu"):
        assert profiling.enabled()
    assert not profiling.enabled()
    with pytest.raises(KeyError):
        with profiling.trace(str(tmp_path), device="cpu"):
            raise KeyError("inside")
    assert not profiling.enabled()
    profiling.enable()
    with profiling.trace(str(tmp_path), device="cpu"):
        pass
    assert profiling.enabled()


def test_render_and_step_spans_on_the_cpu(tmp_path, tracing_off):
    """The eager paths' top spans carry their calls' sequence numbers, and
    the step's parts nest inside their step by time."""
    cfg, chain = _cpu_chain()
    ann = profiling.annotate_chain(chain)
    x = _signal()
    sp = pt.StreamProcessor(chain, cfg, (2,))
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        pt.render(ann, x, cfg)
        pt.render(chain, x, cfg)
        for i in range(3):
            sp.process(x[:, i * B:(i + 1) * B])
    spans = _user_spans(prof)
    renders = sorted((a, n) for n, a, _ in spans if n.startswith("render#"))
    seqs = [int(n.split("#")[1]) for _, n in renders]
    assert len(seqs) == 2 and seqs[1] == seqs[0] + 1
    steps = sorted((a, b, n) for n, a, b in spans if n.startswith("step#"))
    assert [n for _, _, n in steps] == ["step#0", "step#1", "step#2"]
    for part in ("step.to_tensor", "step.copy_out"):
        inside = [(a, b) for n, a, b in spans if n == part]
        assert len(inside) == 3
        for (a, b), (s0, s1, _) in zip(sorted(inside), steps):
            assert s0 <= a <= b <= s1, part
    # the annotated render's effect scopes nest in its render span
    first = [(a, b) for n, a, b in spans if n == renders[0][1]][0]
    scopes = [(a, b) for n, a, b in spans if n.startswith("effect.")]
    assert scopes and all(first[0] <= a <= b <= first[1] for a, b in scopes)
    got = profiling.attribute(prof)["spans"]
    assert got["render"]["count"] == 2 and got["step"]["count"] == 3
    assert got["step.to_tensor"]["count"] == got["step.copy_out"]["count"] \
        == 3
    assert got["step"]["self_s"] < got["step"]["host_s"]


def test_the_capture_counter_is_unchanged_by_an_eager_call(tracing_off):
    from pyaudiodsptools_tpu_torch.engine import graph

    before = (graph.capture_s, graph.captures)
    assert isinstance(before[0], float) and isinstance(before[1], int)
    cfg, chain = _cpu_chain()
    x = _signal()
    pt.render(chain, x, cfg)
    sp = pt.StreamProcessor(chain, cfg, (2,))
    sp.warmup()
    sp.process(x[:, :B])
    assert (graph.capture_s, graph.captures) == before


def test_unique_stage_names():
    assert profiling.unique(["tail", "fir_cascade", "tail", "tail"]) == \
        ["tail", "fir_cascade", "tail.1", "tail.2"]


class _Event:
    """A stand-in for a profiler's event (``_KinetoEvent``'s methods)."""

    def __init__(self, kind, name, t0, t1, corr=0, thread=1):
        self.kind, self._name, self.t0, self.t1 = kind, name, t0, t1
        self.corr, self.thread = corr, thread

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.kind in (
            "kernel", "gpu_memcpy", "gpu_memset") else \
            torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self.kind == "user_annotation"

    def name(self):
        return self._name

    def start_ns(self):
        return self.t0

    def end_ns(self):
        return self.t1

    def correlation_id(self):
        return self.corr

    def start_thread_id(self):
        return self.thread


MARK = "void trace_mark_kernel()"


def _replay_events(t, corr, stage_ops, span="render"):
    """One call at ``t`` (ns): its top span, a copy launched in
    ``<span>.copy_in``, a graph launch in ``<span>.replay`` whose marks
    bound the stages, each stage's operations given as (start, end) offsets
    from its first mark; a copy launched in ``<span>.copy_out``."""
    ev = [_Event("user_annotation", f"{span}#{corr}", t, t + 1000),
          _Event("user_annotation", f"{span}.copy_in", t + 10, t + 60),
          _Event("cuda_runtime", "cudaLaunchKernel", t + 20, t + 30,
                 corr * 10),
          _Event("kernel", "elementwise_kernel", t + 100, t + 150,
                 corr * 10),
          _Event("user_annotation", f"{span}.replay", t + 60, t + 90),
          _Event("cuda_runtime", "cudaGraphLaunch", t + 70, t + 80,
                 corr * 10 + 1)]
    at = t + 200
    ev.append(_Event("kernel", MARK, at, at + 2, corr * 10 + 1))
    for ops in stage_ops:
        end = at + 2
        for a, b in ops:
            ev.append(_Event("kernel", "walk_kernel", at + a, at + b,
                             corr * 10 + 1))
            end = max(end, at + b)
        at = end + 8
        ev.append(_Event("kernel", MARK, at, at + 2, corr * 10 + 1))
    ev += [_Event("user_annotation", f"{span}.copy_out", t + 90, t + 99),
           _Event("cuda_runtime", "cudaMemcpyAsync", t + 92, t + 95,
                  corr * 10 + 2),
           _Event("gpu_memcpy", "Memcpy DtoD (Device -> Device)", at + 10,
                  at + 40, corr * 10 + 2)]
    return ev


def test_attribute_puts_operations_in_spans_and_stages():
    stages = ["fir_cascade", "dynamics_cascade", "tail"]
    ops = [[(2, 52)], [(2, 22), (40, 70)], [(2, 12)]]
    events = _replay_events(0, 1, ops) + _replay_events(10_000, 2, ops)
    got = profiling.attribute(events, stages)
    sp = got["spans"]
    assert sp["render"]["count"] == 2
    assert sp["render.copy_in"]["device_s"] == pytest.approx(2 * 50e-9)
    assert sp["render.copy_out"]["device_s"] == pytest.approx(2 * 30e-9)
    assert sp["render.replay"]["device_s"] == pytest.approx(
        2 * (50 + 20 + 30 + 10) * 1e-9)
    # a parent holds what its children launched; its self time is its own
    assert sp["render"]["device_s"] == pytest.approx(
        sp["render.copy_in"]["device_s"] + sp["render.replay"]["device_s"]
        + sp["render.copy_out"]["device_s"])
    assert sp["render"]["self_s"] == pytest.approx(2 * (1000 - 50 - 30 - 9)
                                                   * 1e-9)
    st = got["stages"]
    assert list(st) == stages
    # a stage from its mark's start (the mark's 2 ns idle in it) to the
    # next mark's: the walks with 18 ns between them, 8 before the mark
    assert st["fir_cascade"] == pytest.approx(
        {"replays": 2, "busy_s": 50e-9, "idle_s": 10e-9})
    assert st["dynamics_cascade"] == pytest.approx(
        {"replays": 2, "busy_s": 50e-9, "idle_s": 28e-9})
    for name in stages:
        assert got["idle_by"]["stage:" + name] == pytest.approx(
            2 * st[name]["idle_s"])
    assert got["replay_busy_s"] == pytest.approx(2 * 110e-9)
    assert got["staged_busy_s"] == got["replay_busy_s"]
    # the marks are in no device sum
    assert got["busy_s"] == pytest.approx(2 * (50 + 110 + 30) * 1e-9)


def test_attribute_without_marks_or_names():
    ops = [[(2, 52)], [(2, 22)]]
    plain = profiling.attribute(_replay_events(0, 1, ops))
    assert list(plain["stages"]) == ["stage.0", "stage.1"]
    no_marks = [e for e in _replay_events(0, 1, ops) if e.name() != MARK]
    got = profiling.attribute(no_marks, ["fir_cascade", "tail"])
    assert got["stages"] == {} and got["staged_busy_s"] == 0
    assert got["spans"]["render.replay"]["device_s"] == pytest.approx(
        70e-9)
    # idle gaps outside any stage go to the innermost span, else "none"
    assert set(got["idle_by"]) <= {"render", "render.copy_in",
                                   "render.replay", "render.copy_out",
                                   "none"}


def test_attribute_takes_the_names_in_turn_over_pieces():
    """A gloo program's pieces are graphs of one stage each: replay after
    replay, each takes the next name, and the names start again."""
    pieces = ["program.0", "program.1", "program.2"]
    events = []
    for k in range(6):
        events += _replay_events(k * 5000, k + 1, [[(2, 10 + k)]],
                                 span="sharded")
    got = profiling.attribute(events, pieces)
    assert list(got["stages"]) == pieces
    assert [got["stages"][p]["replays"] for p in pieces] == [2, 2, 2]
    assert got["stages"]["program.2"]["busy_s"] == pytest.approx(
        (10 + 13) / 2 * 1e-9)


def test_attribute_labels_gaps_inside_a_window():
    ev = _replay_events(0, 1, [[(2, 52)]])
    ev.append(_Event("user_annotation", "caller.window", -500, 2000))
    got = profiling.attribute(ev, ["fir_cascade"], window=(-500, 2000))
    assert got["window_s"] == pytest.approx(2500e-9)
    idle = got["idle_by"]
    assert idle["stage:fir_cascade"] == pytest.approx(10e-9)
    assert "caller.window" in idle and "none" not in idle
    assert sum(idle.values()) == pytest.approx(got["window_s"]
                                               - got["busy_s"])
