"""PyTorch/CUDA port: the captured sharded render (``parallel/captured.py``,
``CapturedShardedRender``; the rank program of ``parallel/sharding.py``;
``kernels/dynamics.py``'s round step), in one process.

The JAX package jit-compiles a device's whole share of its sharded render
(``pyaudiodsptools_tpu/parallel/sharding.py``: ``jax.jit(
_render_with_constraints)``), its collectives and dynspec's ``while_loop``
inside; the port captures a rank's program in CUDA graphs on the card, one
graph where the mesh's exchanges go through NCCL, one a piece between
exchanges where they go through gloo. The CPU tests here hold:

* the cuts, as a pure function of the chain, the mesh shape, the block size
  and ``capturable``, for chain8, the undecayed-EQ chain and the lowcut whose
  halo is longer than a shard: every exchange under gloo, none under NCCL;
* the round step's plain version against a numpy mirror of the body of JAX's
  ``lax.while_loop`` (``parallel/dynspec.py:127-147``), as
  ``test_torch_compiled_render.py`` holds the settle step's;
* the serial walk into given buffers (what the rounds' while node needs);
* the buffered exchanges of a mesh of one rank (no process group);
* the refusals: a CPU chain, a shape that does not split over the mesh.

The programs played piece by piece over real gloo ranks (bit-equal to
``render_shard``, held to the JAX package's renderer and dynspec, the host
reads) are in ``test_torch_parallel.py``, which holds the multi-process
jobs: one job a mesh shape, computed once for both files' worth of cases.

The ``cuda`` tests (skipped without a card) capture on a 1x1 mesh of a
one-rank NCCL group: bit-equal to eager and to ``Chain.captured_render``,
one program kept. They import no JAX: ``python -m pytest --noconftest -m
cuda tests/test_torch_sharded_capture.py`` runs on a machine with a card and
no JAX.
"""

import numpy as np
import pytest
import torch

import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu_torch.kernels import dynamics as kd
from pyaudiodsptools_tpu_torch.kernels import graph_cond as kgc
from pyaudiodsptools_tpu_torch.parallel import (Mesh, ShardedRenderer,
                                                make_mesh, single_device_mesh)
from pyaudiodsptools_tpu_torch.parallel.captured import CapturedShardedRender
from pyaudiodsptools_tpu_torch.parallel.mesh import Exchange, play
from pyaudiodsptools_tpu_torch.parallel.sharding import plan_cuts

import torch_dist_worker as worker

CPU = "cpu"
B = worker.B
FIR8 = "fir_cascade:lowcut+highcut+eq3band_fft"
TAIL8 = "tail:delay+tremolo+softclipper"


def _chains():
    cfg = pt.EngineConfig(44100, B)
    return {"chain8": pt.Chain(worker.chain8_effects(pt, cfg, device=CPU),
                               device=CPU),
            "eq_chain": pt.Chain(worker.eq_effects(pt, cfg, device=CPU),
                                 device=CPU),
            "lowcut": pt.Chain([pt.ops.lowcut(cfg, 400.0, device=CPU)],
                               device=CPU)}


def _shape(c, t):
    return {"channel": c, "time": t}


# ---------------------------------------------------------------------------
# the pieces


@pytest.mark.parametrize("chain,shape,want", [
    ("chain8", (1, 1), []),
    ("chain8", (2, 1), ["gather"]),
    ("chain8", (1, 2), [f"{FIR8}: halo", "dynspec rounds", f"{TAIL8}: halo",
                        "gather"]),
    ("chain8", (2, 2), [f"{FIR8}: halo", "dynspec rounds", f"{TAIL8}: halo",
                        "gather"]),
    ("eq_chain", (2, 1), ["gather"]),
    ("eq_chain", (1, 4), ["lowcut: halo", "timescan band 0: halo",
                          "timescan band 0: summaries", "gather"]),
    ("lowcut", (1, 4), ["lowcut: halo", "gather"]),
    ("lowcut", (4, 1), ["gather"]),
])
def test_gloo_cuts_every_exchange_and_nccl_none(chain, shape, want):
    """Under gloo each exchange ends a piece (the time == 1 dynamics stage
    of chain8 runs its own fixpoint inside a piece); under NCCL the rank's
    program is one graph, dynspec's rounds in its while node."""
    ch = _chains()[chain]
    assert plan_cuts(ch, _shape(*shape), B, capturable=False) == want
    assert plan_cuts(ch, _shape(*shape), B, capturable=True) == []


def test_the_cuts_follow_the_reach_and_the_block_size():
    """A halo exchange exists where the reach needs blocks: a waveshaper
    reaches back nothing, a delay more than a block."""
    cfg = pt.EngineConfig(44100, B)
    clip = pt.Chain([pt.ops.softclipper(cfg, device=CPU)], device=CPU)
    assert plan_cuts(clip, _shape(1, 2), B, False) == ["gather"]
    dly = pt.Chain([pt.ops.delay(cfg, 150.0, 2, device=CPU)], device=CPU)
    assert plan_cuts(dly, _shape(1, 2), B, False) == [
        f"{dly.exec_effects[0].name}: halo", "gather"]


# ---------------------------------------------------------------------------
# the round step


def _mirror_round(came: np.ndarray, e: np.ndarray, flags, first: bool):
    """The body of JAX's dynspec loop after its ppermute, in numpy: the next
    entries are the previous time rank's exits (REST, 0, on time rank 0),
    ``moved`` where one differs from the entry walked from; the round
    counted where the loop runs it (the first, or after a round that moved
    an entry: ``flags[0]`` as the last all-reduce left it)."""
    nxt = np.zeros_like(e) if first else came.copy()
    moved = int(not np.array_equal(nxt, e))
    live = int(flags[1] == 0 or flags[0] != 0)
    return nxt, [moved, flags[1] + live, flags[2] + live]


@pytest.mark.parametrize("flags", [(0, 0, 5), (1, 2, 5), (0, 2, 5)])
@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("C", [1, 3, 64])
@pytest.mark.parametrize("n_ops", [1, 2, kd.MAX_OPS])
def test_round_step_plain_matches_the_numpy_mirror(n_ops, C, first, flags):
    rng = np.random.default_rng(n_ops * 1000 + C * 10 + first)
    came = rng.integers(-1, 400, (n_ops, C)).astype(np.int32)
    for e0 in (rng.integers(-1, 400, (n_ops, C)).astype(np.int32),
               came.copy(), np.zeros((n_ops, C), np.int32)):
        want, want_flags = _mirror_round(came, e0, list(flags), first)
        e = torch.from_numpy(e0.copy())
        f = torch.tensor(flags, dtype=torch.int32)
        assert kd.round_live(f) == bool(flags[1] == 0 or flags[0])
        kd.round_step(None if first else torch.from_numpy(came), e, f, first)
        np.testing.assert_array_equal(e.numpy(), want)
        assert f.tolist() == want_flags


def test_round_step_checks_its_buffers():
    e = torch.zeros((2, 4), dtype=torch.int32)
    flags = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        kd.round_step(e, e.float(), flags, False)
    with pytest.raises(ValueError, match="int32\\[3\\]"):
        kd.round_step(e.clone(), e, torch.zeros(2, dtype=torch.int32), False)
    with pytest.raises(ValueError, match="came"):
        kd.round_step(torch.zeros((2, 3), dtype=torch.int32), e, flags, False)
    with pytest.raises(ValueError, match="card"):
        kd.round_gate(flags, 0)
    kd.round_step(None, e, flags, True)       # the first rank takes no exits
    assert flags.tolist() == [0, 1, 1]
    assert not kd.round_live(flags)           # past the fixpoint
    kd.round_step(None, e, flags, True)
    assert flags.tolist() == [0, 1, 1]


def test_serial_walk_writes_into_given_buffers():
    cfg = pt.EngineConfig(44100, B)
    comp = pt.ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1, device=CPU)
    gate = pt.ops.gate(cfg, -45.0, 0.1, 3.1, 200.1, device=CPU)
    sc = [kd.op_scalars(comp.params), kd.op_scalars(gate.params)]
    x = torch.from_numpy(worker.burst(3, 2000, 4))
    entry = torch.tensor([[0, 5, -1], [0, 1, 0]], dtype=torch.int32)
    want_y, want_z = kd.serial_walk(sc, x, entry)
    out, exits = torch.full_like(x, np.nan), torch.full_like(entry, 77)
    y, z = kd.serial_walk(sc, x, entry, out=out, exit_state=exits)
    assert y is out and z is exits
    assert torch.equal(out, want_y) and torch.equal(exits, want_z)
    with pytest.raises(ValueError, match="out"):
        kd.serial_walk(sc, x, entry, out=x)


# ---------------------------------------------------------------------------
# the exchanges and the refusals


def test_one_rank_mesh_exchanges_into_buffers():
    """A mesh of one rank has no group: its buffered exchanges copy, reduce
    nothing, receive nothing; it is capturable (nothing to stage)."""
    mesh = single_device_mesh(CPU)
    assert mesh.capturable
    x = torch.arange(6.0).reshape(2, 3)
    out = torch.zeros((1, 2, 3))
    assert mesh.all_gather_into(x, out, "time") is out
    assert torch.equal(out[0], x)
    assert mesh.all_reduce_(x, "sum") is x
    kept = torch.full((2, 3), 5.0)
    assert not mesh.shift_into(x, kept) and bool((kept == 5.0).all())
    assert mesh.shift(x) is None
    mesh.warmup()                     # no group: nothing to make


def test_play_runs_each_exchange_in_order():
    seen = []

    def program():
        yield Exchange("a", lambda: seen.append(1))
        yield Exchange("b", lambda: seen.append(2))
        return "out"

    done = []
    assert play(program(), done) == "out"
    assert seen == [1, 2] and done == ["a", "b"]


def _two_rank_view(c, t) -> Mesh:
    """Rank 0's view of a c x t mesh, without process groups (enough for
    what is checked before any exchange)."""
    return Mesh(shape=_shape(c, t), coords=(0, 0), device=torch.device(CPU),
                groups={"channel": None, "time": None}, group=None,
                ranks=tuple(range(c * t)))


def test_captured_render_refuses_a_cpu_chain():
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain([pt.ops.softclipper(cfg, device=CPU)], device=CPU)
    r = ShardedRenderer(chain, cfg, single_device_mesh(CPU))
    with pytest.raises(ValueError, match="CUDA device"):
        CapturedShardedRender(chain, r.mesh)
    with pytest.raises(ValueError, match="CUDA device"):
        r.captured


@pytest.mark.parametrize("shape,blocks", [((2, 1), (3, 4, B)),
                                          ((1, 2), (2, 5, B)),
                                          ((2, 2), (4, 3, B))])
def test_a_shape_that_does_not_split_is_refused(shape, blocks):
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain([pt.ops.softclipper(cfg, device=CPU)], device=CPU)
    r = ShardedRenderer(chain, cfg, _two_rank_view(*shape))
    with pytest.raises(ValueError, match="do not split"):
        r.shard_shape(blocks)
    with pytest.raises(ValueError, match="do not split"):
        r.render_blocks(torch.zeros(blocks))
    with pytest.raises(ValueError, match="num_blocks, block_size"):
        r.shard_shape((4, B))


# ---------------------------------------------------------------------------
# on the card (skipped here)


@pytest.fixture
def one_rank_nccl():
    """A one-rank NCCL group on the card (a 1x1 mesh needs none; the group
    makes the mesh the one ``chip_smoke.py`` renders on)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        yield make_mesh(1, 1)
    finally:
        torch.distributed.destroy_process_group()


def _card_chain8():
    cfg = pt.EngineConfig(44100, B)
    return cfg, pt.Chain(worker.chain8_effects(pt, cfg, device="cuda"),
                         device="cuda")


@pytest.mark.cuda
def test_cuda_1x1_captured_equals_eager_and_the_chain_render(one_rank_nccl):
    cfg, chain = _card_chain8()
    rend = ShardedRenderer(chain, cfg, one_rank_nccl)
    x = torch.from_numpy(worker.burst(4, 24 * B - 77, 3)).cuda()
    with kgc.fixpoints() as flags:
        eager = pt.block.combine_blocks(rend.gather(rend.render_shard(
            rend.shard(pt.block.make_blocks(
                torch.nn.functional.pad(x, (0, 77)), B)))))
    walks = [int(f[kd.FLAG_WALKS]) for f in flags]
    got = rend.render(x)
    assert torch.equal(got, eager)
    assert rend.captured.walks() == walks
    assert torch.equal(got, pt.render(chain, x, cfg))    # padded alike
    assert torch.equal(rend.render(x), got)          # a repeated replay
    assert rend.captured.cuts() == [] and one_rank_nccl.capturable
    rend.captured.release()
    chain.captured_render().release()


@pytest.mark.cuda
def test_cuda_the_captured_render_keeps_one_program(one_rank_nccl):
    cfg, chain = _card_chain8()
    rend = ShardedRenderer(chain, cfg, one_rank_nccl)
    for nb in (8, 12, 8):
        x = torch.from_numpy(worker.noise(2, nb * B, nb)).cuda()
        y = rend.render(x)
        assert rend.captured.kept == ("global", (2, nb, B))
        assert torch.equal(y, pt.render(chain, x, cfg))
    rend.captured.release()
    assert rend.captured.kept is None
    chain.captured_render().release()


@pytest.mark.cuda
def test_cuda_a_renderer_dropped_frees_its_graphs(one_rank_nccl):
    """The captured program holds no reference to its renderer: dropping the
    renderer frees the graphs at once (reference counting), not whenever
    the garbage collector runs, which could be inside another capture."""
    import gc
    import weakref
    cfg, chain = _card_chain8()
    rend = ShardedRenderer(chain, cfg, one_rank_nccl)
    rend.render(torch.from_numpy(worker.noise(2, 8 * B, 1)).cuda())
    gone = weakref.ref(rend.captured)
    gc.disable()
    try:
        del rend
        assert gone() is None
    finally:
        gc.enable()
    chain.captured_render().release()


@pytest.mark.cuda
def test_cuda_a_traced_program_marks_its_stages(one_rank_nccl):
    """Captured with tracing off the program has no stage; captured again
    with it on, a 1x1 mesh's program (no exchange) is one stretch of work
    between two marks, and renders the same bits."""
    from pyaudiodsptools_tpu_torch import profiling

    cfg, chain = _card_chain8()
    rend = ShardedRenderer(chain, cfg, one_rank_nccl)
    x = torch.from_numpy(worker.noise(2, 8 * B, 4)).cuda()
    want = rend.render(x)
    assert rend.captured.stages() == []
    rend.captured.release()
    profiling.enable()
    try:
        got = rend.render(x)
    finally:
        profiling.enable(False)
    assert rend.captured.stages() == ["program.0"]
    assert torch.equal(got, want)
    rend.captured.release()
    chain.captured_render().release()
