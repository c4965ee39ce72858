"""PyTorch/CUDA port, the module that holds the fused-tail kernel
(``kernels/tail.py``): its plain version against the JAX package's Pallas
kernel in interpret mode; the planner against the JAX planner; the numpy
mirror of the CUDA schedule against the plain version; and, on a card, the
kernel itself."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyaudiodsptools_tpu as jx
import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu.kernels import tail_pallas as jx_tail
from pyaudiodsptools_tpu_torch.kernels import tail as pt_tail
from pyaudiodsptools_tpu_torch.ops.tremolo import TremoloParams, gain_row

from torch_port_util import emulate_tail, snr_db

CPU = "cpu"
JCFG = jx.EngineConfig(sample_rate=44100, block_size=512)
PCFG = pt.EngineConfig(sample_rate=44100, block_size=512)

# plan name -> [(op, args, kwargs)]
PLANS = {
    "delay+tremolo+softclipper": [
        ("delay", (150.0, 2), {}), ("tremolo", (0.3, 5.0), {}),
        ("softclipper", (0.44,), {})],
    "saturator+delay+tremolo+softclipper": [       # the flagship tail
        ("saturator", (), {}), ("delay", (150.0, 2), {}),
        ("tremolo", (0.3, 5.0), {}), ("softclipper", (0.44,), {})],
    "harddistortion+wet_delay": [
        ("harddistortion", (), {}), ("delay", (40.0, 2), {"wet": True})],
    "delay+delay": [
        ("delay", (30.0, 2), {}), ("delay", (7.0, 3), {})],
    # one-stage plans: a lone waveshaper's offline on a card
    "softclipper": [("softclipper", (0.44,), {})],
    "saturator": [("saturator", (-18.0, 1.5, "soft"), {})],
    "harddistortion": [("harddistortion", (), {})],
    "bitcrusher": [("bitcrusher", (), {})],
}


def _members(pkg, cfg, plan, **kw):
    return [getattr(pkg.ops, op)(cfg, *args, **kwargs, **kw)
            for op, args, kwargs in PLANS[plan]]


def _blocks(C, nb, seed):
    x = (np.random.default_rng(seed).standard_normal((C, nb, 512)) * 0.5
         ).astype(np.float32)
    return x[0] if C == 1 else x


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("plan", list(PLANS))
def test_fused_tail_matches_pallas_kernel(plan, C):
    # 70 blocks of 512 = 35,840 samples: two tiles of the Pallas kernel's
    # 32,768, the last one ragged
    x = _blocks(C, 70, seed=len(plan) + C)
    jfused = jx_tail.fused_tail(_members(jx, JCFG, plan), interpret=True)
    pfused = pt_tail.fused_tail(_members(pt, PCFG, plan, device=CPU))
    assert pfused.name == jfused.name
    want = np.asarray(jfused.offline(jfused.params, jnp.asarray(x)))
    got = pfused.offline(pfused.params, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    # pow and sin differ between the libraries by ulps
    assert snr_db(want, got) >= 100.0


@pytest.mark.parametrize("plan", list(PLANS))
def test_plan_stages_match_jax(plan):
    jst, jn_scal, jn_gain, jD = jx_tail._plan_stages(_members(jx, JCFG, plan))
    members = _members(pt, PCFG, plan, device=CPU)
    pst, pn_scal, pn_gain, pD = pt_tail._plan_stages(members)
    assert [s[0] for s in pst] == [s[0] for s in jst]
    assert (pn_scal, pn_gain, pD) == (jn_scal, jn_gain, jD)
    for ps, js in zip(pst, jst):
        if ps[0] == "taps":
            assert ps[1:] == js[1:]             # offsets, wet, scalar base
        elif ps[0] == "gain":
            assert ps[1] == js[1]
        else:
            assert ps[2:] == js[3:]             # scalar base, leaf count
    assert all(pt_tail.tail_fusable(e) for e in members)


def test_tail_fusable_matches_jax():
    for op, args, kw in [("delay", (20.0, 2), {"use_lowcut_filter": True}),
                         ("lowcut", (120.0,), {}), ("bitcrusher", (), {}),
                         ("tremolo", (0.3, 5.0), {})]:
        je = getattr(jx.ops, op)(JCFG, *args, **kw)
        pe = getattr(pt.ops, op)(PCFG, *args, **kw, device=CPU)
        assert pt_tail.tail_fusable(pe) == jx_tail.tail_fusable(je)


MIRROR_PLANS = list(PLANS) + ["bitcrusher+delay", "delay+bitcrusher",
                               "tremolo+softclipper"]
PLANS["bitcrusher+delay"] = [("bitcrusher", (), {}), ("delay", (9.0, 2), {})]
PLANS["delay+bitcrusher"] = [("delay", (9.0, 3), {}), ("bitcrusher", (), {})]
PLANS["tremolo+softclipper"] = [("tremolo", (0.3, 5.0), {}),
                                ("softclipper", (0.44,), {})]


@pytest.mark.parametrize("tile,runs", [(256, 5), (1024, 3), (512, 4),
                                       (None, None)])
@pytest.mark.parametrize("plan", MIRROR_PLANS)
def test_cuda_schedule_mirror_matches_plain(plan, tile, runs):
    """csrc/tail.cu's schedule, mirrored in numpy from the very stage table
    the launcher passes: rings indexed by time modulo their length (small
    tiles make them wrap dozens of times), runs that walk the halo's tiles
    first (their rings start as NaN), the pointwise run before the first
    taps stage in place, a taps stage into the next one's ring, the last one
    four positions at a time, the ragged last tile; the next tile landing
    before the current one is read."""
    members = _members(pt, PCFG, plan, device=CPU)
    fused = pt_tail.fused_tail(members)
    nb, B = 70, 512
    x = _blocks(2, nb, seed=11)
    x[0, 0, :6] = [1.4, -1.4, 0.0, 2.2, -0.79, 0.81]
    stages, _, _, D = pt_tail._plan_stages(members)
    kplan = pt_tail.make_plan(stages, D, fused.params, CPU, tile=tile)
    T = nb * B - 37                                 # not a multiple of 4
    if runs is None:
        runs = pt_tail.runs_for(kplan, 2, T, sms=132)
    rows = [gain_row(p, nb, B).numpy()[:T] for p in fused.params
            if isinstance(p, TremoloParams)]
    gains = np.stack(rows) if rows else None
    mirror = emulate_tail(x.reshape(2, -1)[:, :T], gains, kplan, runs)
    assert np.isfinite(mirror).all()
    want = fused.offline(fused.params, torch.from_numpy(x)).numpy()
    want = want.reshape(2, -1)[:, :T]
    if "bitcrusher" in plan:
        # one ulp before the floor division is a whole 1/64 step: exact or
        # nothing. No transcendental precedes it in these plans.
        np.testing.assert_array_equal(want, mirror)
    else:
        assert snr_db(want, mirror) >= 120.0


def test_stage_table_of_the_flagship_tail():
    members = _members(pt, PCFG, "saturator+delay+tremolo+softclipper",
                       device=CPU)
    stages, n_scal, n_gain, D = pt_tail._plan_stages(members)
    assert [s[0] for s in stages] == ["map", "taps", "gain", "map"]
    assert D == 13230 and n_gain == 1 and n_scal == 5
    plan = pt_tail.make_plan(stages, D, tuple(e.params for e in members), CPU)
    t = plan.table.numpy()
    assert t.dtype == np.int32 and t.shape == (8 + 4 * 8 + 2 * 2,)
    assert list(t[:4]) == [4, 2, 1, 1]         # stages, taps, first, last taps
    row = lambda k: t[8 + 8 * k:16 + 8 * k]
    f32 = lambda v: np.int32(v).view(np.float32)
    # one taps stage: its ring is the halo in whole tiles, the tile worked
    # on and the next: 96 KB, two blocks an SM
    assert (plan.tile, plan.ring_smem, plan.blocks_per_sm) == (4096, True, 2)
    assert plan.ring_floats == (4 + 2) * 4096 and plan.warm_tiles == 4
    assert list(row(1)[:5]) == [0, 0, 2, 0, plan.ring_floats]
    assert f32(row(1)[5]) == 1.0 and row(1)[7] == 4     # dry, no next taps
    assert list(t[40:42]) == [6615, 13230]
    assert list(t[42:44].view(np.float32)) == [0.5, np.float32(0.1)]
    assert list(row(0)[:3]) == [2, 0, 1]                # saturator, 'hard'
    assert list(row(2)[:2]) == [1, 0]                   # gain row 0
    assert row(3)[1] == 1 and f32(row(3)[5]) == np.float32(1.44)


def test_tile_shrinks_with_the_halo_and_gives_up_when_it_cannot_fit():
    """The tile and the rings' place follow the halo; where the rings cannot
    fit shared memory at all they go to device memory: nothing is refused
    but a halo beyond int32 indexing."""
    taps = lambda *d: [("taps", tuple(d), False, 0)]
    # the flagship halo: two blocks an SM, the largest tile
    assert pt_tail.geometry(taps(6615, 13230)) == (4096, True, 2)
    assert pt_tail.geometry([("gain", 0)]) == (4096, True, 2)
    # a halo too long for two blocks per SM: one block, the tile that fits
    assert pt_tail.geometry(taps(50000)) == (2048, True, 1)
    assert 4 * pt_tail.ring_layout(taps(50000), 2048)[1] <= pt_tail.SMEM_LIMIT
    # beyond that the rings live in device memory: D + 2S and a tile's
    # rounding a block
    for d in (58000, 88200):
        S, smem, _ = pt_tail.geometry(taps(d))
        assert not smem and S == pt_tail.SCRATCH_TILE
        assert d + 2 * S <= pt_tail.ring_layout(taps(d), S)[1] < d + 3 * S
    # a table too large for shared memory is read from device memory
    big = taps(*range(4, 8404, 4))
    assert not pt_tail.make_plan(big, 8400, (pt.ops.delay(
        PCFG, 0.1, 2100, device=CPU).params,), CPU).table_smem
    # two taps stages: one ring each, the second without the landing tile
    assert pt_tail.ring_layout(taps(300) + taps(5000), 1024) == \
        ([(0, 3072), (3072, 6144)], 9216)
    assert pt_tail.ring_layout([("gain", 0)], 1024) == ([], 2048)
    # what the stage table takes is not capped any more
    pt_tail.check_plan(taps(58000), 58000)
    pt_tail.check_plan(taps(*range(1, 80)), 79)
    pt_tail.check_plan([("gain", k) for k in range(17)], 0)
    with pytest.raises(ValueError, match="int32"):
        pt_tail.check_plan(taps(2 ** 31 - 5), 2 ** 31 - 5)
    # runs per channel: two blocks an SM, no run shorter than its halo walk
    plan = pt_tail.make_plan(taps(6615, 13230), 13230,
                             (pt.ops.delay(PCFG, 150.0, 2, device=CPU).params,),
                             CPU)
    T = 64 * 20671                              # chain8's 30 s, padded
    assert pt_tail.runs_for(plan, 64, 1323008, sms=132) == 4
    assert pt_tail.runs_for(plan, 1, 1323008, sms=132) == 65   # 5 tiles a run
    assert pt_tail.runs_for(plan, 1000, T, sms=132) == 1
    assert pt_tail.runs_for(plan, 3, 5000, sms=132) == 1


def test_fused_tail_refuses_a_run_its_kernel_cannot_take():
    """Nothing is refused any more: a 700 ms delay's halo (61,740 samples),
    and one of 1,000 ms (88,200), are fused and built into a Chain on any
    device; their rings go to device memory. Rendered, the fused run equals
    its members run one by one."""
    o = pt.ops
    for ms in (700.0, 1000.0):
        long_run = [o.delay(PCFG, ms, 2, device=CPU),
                    o.softclipper(PCFG, device=CPU)]
        fused = pt_tail.fused_tail(long_run)
        assert fused.name == "tail:delay+softclipper"
        chain = pt.Chain(long_run, device=CPU)
        assert [e.name for e in chain.exec_effects] == [fused.name]
        unfused = pt.Chain(long_run, fuse=False, device=CPU)
        assert [e.name for e in unfused.exec_effects] == ["delay",
                                                          "softclipper"]
        x = torch.from_numpy(_blocks(2, 200, seed=5))
        want = long_run[1].offline(long_run[1].params,
                                   long_run[0].offline(long_run[0].params, x))
        assert torch.equal(chain.render_blocks(x), want)
        assert torch.equal(unfused.render_blocks(x), want)
        stages, _, _, D = pt_tail._plan_stages(long_run)
        plan = pt_tail.make_plan(stages, D, fused.params, CPU)
        assert D == int(ms * 44.1) * 2 and not plan.ring_smem
    # 65 taps: past the old table's 64, in shared memory
    many = pt_tail.fused_tail([o.delay(PCFG, 10.0, 65, device=CPU),
                               o.softclipper(PCFG, device=CPU)])
    stages, _, _, D = pt_tail._plan_stages(
        [o.delay(PCFG, 10.0, 65, device=CPU)])
    assert D == 28665 and len(stages[0][1]) == 65
    assert pt_tail.make_plan(stages, D, many.params[:1], CPU).ring_smem
    assert not hasattr(pt_tail, "sequential_count")


def test_cpu_render_counts_neither_launch_nor_sequential():
    before = pt_tail.launch_count
    fused = pt_tail.fused_tail(_members(pt, PCFG, "delay+delay", device=CPU))
    fused.offline(fused.params, torch.zeros(2, 8, 512))
    assert pt_tail.launch_count == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        pt_tail.tail_kernel(pt_tail.make_plan([], 0, (), CPU),
                            torch.zeros(2, 64), None)


def test_fused_tail_step_runs_the_members_steps():
    members = _members(pt, PCFG, "saturator+delay+tremolo+softclipper",
                       device=CPU)
    fused = pt_tail.fused_tail(members)
    blocks = torch.from_numpy(_blocks(2, 40, seed=2))
    state = fused.state((2,))
    assert state[1]["buffer"].device == fused.device == torch.device(CPU)
    outs = []
    for i in range(blocks.shape[-2]):
        state, y = fused(state, blocks[:, i])
        outs.append(y)
    want = fused.offline(fused.params, blocks).numpy()
    assert snr_db(want, torch.stack(outs, dim=-2).numpy()) >= 120.0


@pytest.mark.cuda
@pytest.mark.parametrize("plan", MIRROR_PLANS)
def test_cuda_kernel_matches_plain_on_card(plan):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    fused = pt_tail.fused_tail(_members(pt, PCFG, plan, device="cuda"))
    x = torch.from_numpy(_blocks(3, 70, seed=4)).cuda()
    before = pt_tail.launch_count
    got = fused.offline(fused.params, x)
    torch.cuda.synchronize()
    assert pt_tail.launch_count == before + 1
    want = fused.offline(fused.params, x, use_kernels=False)
    if "bitcrusher" in plan:
        assert torch.equal(want, got)
    else:
        assert snr_db(want.cpu().numpy(), got.cpu().numpy()) >= 110.0


@pytest.mark.cuda
@pytest.mark.parametrize("delay_args,tile,runs", [
    ((1000.0, 2), None, None),       # rings in device memory
    ((10.0, 65), None, None),        # 65 taps
    ((150.0, 2), 256, 7),            # rings that wrap, runs that walk the halo
])
def test_long_and_small_tile_runs_match_plain_on_card(delay_args, tile, runs):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    members = [pt.ops.delay(PCFG, *delay_args, device="cuda"),
               pt.ops.tremolo(PCFG, 0.3, 5.0, device="cuda"),
               pt.ops.softclipper(PCFG, 0.44, device="cuda")]
    fused = pt_tail.fused_tail(members)
    stages, _, _, D = pt_tail._plan_stages(members)
    plan = pt_tail.make_plan(stages, D, fused.params, "cuda", tile=tile)
    nb = 400
    x = torch.from_numpy(_blocks(3, nb, seed=8)).cuda()
    gains = gain_row(fused.params[1], nb, 512, "cuda")[None]
    got = pt_tail.tail_kernel(plan, x.reshape(3, -1), gains, runs=runs)
    want = fused.offline(fused.params, x, use_kernels=False).reshape(3, -1)
    assert snr_db(want.cpu().numpy(), got.cpu().numpy()) >= 110.0
