"""PyTorch/CUDA port: the relayout kernels' tile schedule (csrc/relayout.cu).

A thread block moves one tile of 128 rows x 64 lanes. Pack takes one path
(a padded tile, 4-byte accesses); unpack takes the box path (TMA boxes into
a swizzled tile, 4 x 4 blocks transposed in registers, 16-byte stores) where
the tile's lanes are channels of one segment and the launch is aligned, else
the masked path. The numpy mirror of that schedule
(``torch_port_util.emulate_relayout_pack`` / ``emulate_relayout_unpack``)
must write every element of tm, and every valid sample of y, exactly once,
with the value the plain versions give; the grid alone is checked at the
main path's geometry and at the most lanes the wrappers take. The kernels
themselves are held to the plain versions on the card (``chip_smoke.py``'s
``relayout_cases`` and the ``cuda``-marked test below).
"""

import numpy as np
import pytest
import torch

from pyaudiodsptools_tpu_torch.kernels import relayout as rl

from torch_port_util import (RELAYOUT_SUB, RELAYOUT_TL, RELAYOUT_TR,
                             emulate_relayout_pack, emulate_relayout_unpack,
                             relayout_box_launch, relayout_tiles)

# name -> (C, T, segments, pointers aligned, unpack's path): "box" every tile,
# "masked" every tile, "both" some of each
SHAPES = {
    # the existing tests' shapes: T % 4 != 0 or C < 64, every tile masked
    "mono_ragged": (1, 5037, 7, True, "masked"),
    "three_ragged": (3, 5037, 4, True, "masked"),
    "c64_t_odd": (64, 5037, 7, True, "masked"),
    "c64_t4097": (64, 4097, 1, True, "masked"),
    "three_aligned": (3, 4096, 5, True, "masked"),
    # aligned, 64 channels: the box path, ragged last segment (7 * 720 >
    # 5,036) and L = 720 not a multiple of 128 rows
    "c64_ragged": (64, 5036, 7, True, "box"),
    "c64_one_segment": (64, 4096, 1, True, "box"),
    "c64_even": (64, 65536, 64, True, "box"),
    # 128 channels: two tiles a segment
    "c128": (128, 2000, 4, True, "box"),
    # 96 channels: every other lane tile straddles two segments, and the last
    # one holds pad lanes
    "c96_straddles": (96, 5036, 7, True, "both"),
    # 80 channels, G = 3: one lane tile in a segment, three straddling, the
    # last with the pad lanes 240 .. 255 (Rp = 256)
    "c80_pad_lanes": (80, 3000, 3, True, "both"),
    # a pointer off 16 bytes: the whole launch masked
    "c64_misaligned": (64, 5036, 7, False, "masked"),
}


def _plan(C, T, segments, aligned):
    G, L, Rp = rl.geometry(C, T, segments)
    return G, L, Rp, relayout_tiles(C, T, G, L, Rp, aligned)


@pytest.mark.parametrize("name", SHAPES)
def test_paths_are_the_expected_ones(name):
    C, T, segments, aligned, path = SHAPES[name]
    G, L, Rp, plan = _plan(C, T, segments, aligned)
    assert plan["box_launch"] == relayout_box_launch(C, T, L, Rp, aligned)
    box = plan["box"]
    assert {"box": box.all(), "masked": not box.any(),
            "both": box.any() and not box.all()}[path], (name, box)
    # a box tile's lanes are 64 channels of one segment, none a pad lane
    g, c0 = plan["g"][box], plan["c0"][box]
    assert (g < G).all() and (c0 + RELAYOUT_TR <= C).all()
    assert (plan["r0"][box] + RELAYOUT_TR <= C * G).all()


@pytest.mark.parametrize("name", SHAPES)
def test_pack_mirror_writes_each_element_once(name):
    C, T, segments, aligned, _ = SHAPES[name]
    G, L, Rp = rl.geometry(C, T, segments)
    rng = np.random.default_rng(C * 1000 + segments)
    x = rng.standard_normal((C, T)).astype(np.float32)
    tm, writes = emulate_relayout_pack(x, G, L, Rp)
    assert (writes == 1).all(), np.argwhere(writes != 1)[:5]
    want = rl.pack_plain(torch.from_numpy(x), G, L, Rp).numpy()
    np.testing.assert_array_equal(tm, want)
    assert not tm[:, C * G:].any()                          # pad lanes
    assert not tm[T - (G - 1) * L:, (G - 1) * C:C * G].any()  # ragged rows


@pytest.mark.parametrize("name", SHAPES)
def test_unpack_mirror_writes_each_sample_once(name):
    C, T, segments, aligned, _ = SHAPES[name]
    G, L, Rp = rl.geometry(C, T, segments)
    rng = np.random.default_rng(C * 1000 + segments + 1)
    x = rng.standard_normal((C, T)).astype(np.float32)
    tm = rl.pack_plain(torch.from_numpy(x), G, L, Rp).numpy()
    # what the pad lanes and ragged rows hold must not reach y
    tm[:, C * G:] = np.nan
    tm[T - (G - 1) * L:, (G - 1) * C:C * G] = np.nan
    y, writes = emulate_relayout_unpack(tm, C, T, G, L, aligned)
    assert (writes == 1).all(), np.argwhere(writes != 1)[:5]
    np.testing.assert_array_equal(y, x)
    np.testing.assert_array_equal(
        y, rl.unpack_plain(torch.from_numpy(tm), C, T, G, L).numpy())


# tile coordinates alone: the main path's geometry (64 ch x 30 s at the
# planner's 256 segments) and the most lanes the wrappers take
GRIDS = {
    "main_path": (64, 1323008, 256),
    "max_lanes_mono": (1, rl.MAX_LANES, rl.MAX_LANES),
    "max_lanes_c64": (64, (rl.MAX_LANES // 64) * 4, rl.MAX_LANES // 64),
}


@pytest.mark.parametrize("name", GRIDS)
def test_grid_on_tile_coordinates(name):
    C, T, segments = GRIDS[name]
    G, L, Rp, plan = _plan(C, T, segments, True)
    assert Rp <= rl.MAX_LANES
    tiles_l, tiles_r = plan["grid"]
    # gridDim.y counts lane tiles: at most 65,535
    assert tiles_r <= 65535 and tiles_l <= 2**31 - 1
    # the tiles partition (L, Rp): full tiles and one clipped row and column
    rows = np.minimum(RELAYOUT_TL, L - np.arange(tiles_l) * RELAYOUT_TL)
    lanes = np.minimum(RELAYOUT_TR, Rp - plan["r0"])
    assert (rows > 0).all() and (lanes > 0).all()
    assert int(rows.sum()) * int(lanes.sum()) == L * Rp
    box = plan["box"]
    if name == "main_path":
        assert (G, L, Rp) == (256, 5168, 16384)
        assert plan["box_launch"] and box.all()
        assert (tiles_l, tiles_r) == (41, 256)
    elif name == "max_lanes_c64":
        assert plan["box_launch"] and box.sum() == C * G // RELAYOUT_TR
    else:
        assert not box.any()                   # C = 1: lanes straddle
    # an unpack's TMA boxes (32 lanes at r0 and r0 + 32) lie inside tm
    if box.any():
        assert int(plan["r0"][box].max()) + 2 * RELAYOUT_SUB <= Rp


def test_box_launch_predicate():
    """Each of the launch-wide conditions alone sends an unpack down the
    masked path."""
    assert relayout_box_launch(64, 5036, 720, 448)
    assert not relayout_box_launch(64, 5037, 720, 448)     # T % 4
    assert not relayout_box_launch(64, 5036, 722, 448)     # L % 4
    assert not relayout_box_launch(64, 5036, 720, 450)     # Rp % 4
    assert not relayout_box_launch(64, 5036, 720, 448, False)
    assert not relayout_box_launch(63, 5036, 720, 448)     # C < 64


@pytest.mark.cuda
@pytest.mark.parametrize("name", SHAPES)
def test_cuda_paths_and_kernels_on_card(name):
    """On the card: the launcher's count of an unpack's box tiles equals
    the mirror's, and both kernels equal their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    C, T, segments, aligned, _ = SHAPES[name]
    G, L, Rp, plan = _plan(C, T, segments, aligned)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(C + segments)
    x = torch.randn((C, T), generator=gen, device="cuda")
    tm = rl.pack(x, G, L, Rp)
    if not aligned:             # tm one float into its allocation
        tm = torch.empty(L * Rp + 1, device="cuda")[1:].view(L, Rp).copy_(tm)
    y = rl.unpack(tm, C, T, G, L)
    box, masked = rl.box_tiles(tm, y, C, T, G, L)
    assert box == int(plan["box"].sum()) * plan["grid"][0]
    assert box + masked == plan["grid"][0] * plan["grid"][1]
    torch.cuda.synchronize()
    assert torch.equal(tm, rl.pack_plain(x, G, L, Rp))
    assert torch.equal(y, x)
