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


MIRROR_PLANS = list(PLANS) + ["bitcrusher+delay", "delay+bitcrusher"]
PLANS["bitcrusher+delay"] = [("bitcrusher", (), {}), ("delay", (9.0, 2), {})]
PLANS["delay+bitcrusher"] = [("delay", (9.0, 3), {}), ("bitcrusher", (), {})]


@pytest.mark.parametrize("plan", MIRROR_PLANS)
def test_cuda_schedule_mirror_matches_plain(plan):
    """csrc/tail.cu's schedule, mirrored in numpy from the very stage table
    the launcher passes: tile + halo window, in-place top-down tap walk,
    re-zeroing before the signal start, ragged last tile."""
    members = _members(pt, PCFG, plan, device=CPU)
    fused = pt_tail.fused_tail(members)
    nb, B = 70, 512
    x = _blocks(2, nb, seed=11)
    x[0, 0, :6] = [1.4, -1.4, 0.0, 2.2, -0.79, 0.81]
    stages, _, _, D = pt_tail._plan_stages(members)
    table = pt_tail._stage_table(stages, D, fused.params)
    rows = [gain_row(p, nb, B).numpy() for p in fused.params
            if isinstance(p, TremoloParams)]
    gains = np.stack(rows) if rows else None
    S = 8192 + 32                                  # 5 tiles, the last ragged
    mirror = emulate_tail(x.reshape(2, -1), gains, table, S, threads=1024)
    assert np.isfinite(mirror).all()
    want = fused.offline(fused.params, torch.from_numpy(x)).numpy().reshape(2, -1)
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
    t = pt_tail._stage_table(stages, D, tuple(e.params for e in members))
    assert (t.n_stages, t.halo) == (4, 13230)
    assert [t.stages[k].zero_after for k in range(4)] == [1, 0, 0, 0]
    # the map before the taps works on the whole window, the rest on the tile
    assert [t.stages[k].lo for k in range(4)] == [0, 13230, 13230, 13230]
    assert list(t.offsets[:2]) == [6615, 13230]
    assert list(t.weights[:2]) == [0.5, np.float32(0.1)]
    assert t.stages[1].p0 == 1.0 and t.stages[1].b == 2     # dry, two taps
    assert t.stages[0].b == 1                               # 'hard' knee
    assert t.stages[3].p0 == np.float32(1.44)


def test_tile_shrinks_with_the_halo_and_gives_up_when_it_cannot_fit():
    T = 1 << 20
    # the flagship halo: two blocks of (halo + tile) floats fit one SM
    S = pt_tail.tile_for(T, 13230)
    assert S == 15424 and 2 * ((13230 + S) * 4 + 2048) <= pt_tail.SMEM_PER_SM
    assert pt_tail.tile_for(T, 0) == pt_tail.MAX_TILE
    # a halo too long for two blocks per SM: one block, the tile that fits
    S = pt_tail.tile_for(T, 50000)
    assert pt_tail.MIN_TILE <= S < pt_tail.MAX_TILE
    assert (50000 + S) * 4 <= pt_tail.SMEM_LIMIT and S % 32 == 0
    assert pt_tail.tile_for(T, 58000) == 0
    assert pt_tail.tile_for(100, 0) == 128          # short signal, one tile
    # what the kernel cannot take is refused by name, not rerouted
    pt_tail.check_plan([("taps", (57000,), False, 0)], 57000)
    with pytest.raises(ValueError, match="shared memory"):
        pt_tail.check_plan([("taps", (58000,), False, 0)], 58000)
    with pytest.raises(ValueError, match="stage table"):
        pt_tail.check_plan([("taps", tuple(range(1, 80)), False, 0)], 79)
    with pytest.raises(ValueError, match="stage table"):
        pt_tail.check_plan([("gain", k) for k in range(17)], 0)


def test_fused_tail_refuses_a_run_its_kernel_cannot_take():
    """No route around the kernel: a 700 ms delay's halo (61,740 samples)
    cannot fit a thread block's shared memory, so the fused effect is not
    built, on any device; the members still run one by one on request."""
    o = pt.ops
    long_run = [o.delay(PCFG, 700.0, 2, device=CPU),
                o.softclipper(PCFG, device=CPU)]
    with pytest.raises(ValueError, match="fuse=False"):
        pt_tail.fused_tail(long_run)
    with pytest.raises(ValueError, match="61740 samples"):
        pt.Chain(long_run, device=CPU)
    unfused = pt.Chain(long_run, fuse=False, device=CPU)
    assert [e.name for e in unfused.exec_effects] == ["delay", "softclipper"]
    x = torch.from_numpy(_blocks(2, 130, seed=5))
    want = long_run[1].offline(long_run[1].params,
                               long_run[0].offline(long_run[0].params, x))
    assert torch.equal(unfused.render_blocks(x), want)
    # 500 ms (44,100 samples) still fits, with a shrunk tile
    assert pt_tail.fused_tail([o.delay(PCFG, 500.0, 2, device=CPU),
                               o.softclipper(PCFG, device=CPU)]).name == \
        "tail:delay+softclipper"
    assert not hasattr(pt_tail, "sequential_count")


def test_cpu_render_counts_neither_launch_nor_sequential():
    before = pt_tail.launch_count
    fused = pt_tail.fused_tail(_members(pt, PCFG, "delay+delay", device=CPU))
    fused.offline(fused.params, torch.zeros(2, 8, 512))
    assert pt_tail.launch_count == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        pt_tail.tail_kernel([], 0, (), torch.zeros(2, 64), None)


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
