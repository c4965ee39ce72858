"""Relayout: natural (C, T) <-> segment-major time-major (L, Rp).

Replaces the TPU kernels ``pyaudiodsptools_tpu/kernels/relayout.py ::
time_major_pack`` and ``time_major_unpack``. The speculative dynamics walks
(``kernels/dynamics.py``) cut time into G segments of L samples (only the
last may be shorter) and give every (segment, channel) pair a lane
``r = g*C + c``; row ``l`` of the time-major array holds sample ``l`` of every
lane, so that neighbouring lanes lie at neighbouring addresses:

    pack    tm[l, r] = x[c, g*L + l]   where g*L + l < T and r < C*G, else 0
    unpack  y[c, g*L + l] = tm[l, r]   for exactly the T valid samples

The JAX array is (L*8, K) with K = Rp/8; its row ``l*8 + r//K``, column
``r%K`` is flat index ``l*Rp + r``, so it is the same memory as this
row-major (L, Rp). The TPU's DMA rules (the (8, 128) tiling, segment lengths
rounded to 128, the zero-extended side buffer, the closing chunk and the
128-wide patch) are not carried over. One thing differs on purpose: the TPU
pack leaves its pad lanes uninitialised; this pack writes zeros into every
pad lane and every row past the last segment's valid length.

On the TPU the walks read that copy. Here their kernels read (C, T) as it
lies and launch neither pack nor unpack; the walks' plain version
(``dynamics.segments_plain``) is built on :func:`pack_plain` and
:func:`unpack_plain`.

What bounds them on an H100: bytes (one read and one write of the signal, no
arithmetic). The CUDA source, ``csrc/relayout.cu``, moves tiles of
``TILE_ROWS`` rows x ``TILE_LANES`` lanes (32 KB), one a thread block, through
shared memory padded against bank conflicts, with 4-byte accesses that run
along time on the natural side and along lanes on the time-major side, and
(g, c) computed once a lane. That is pack's one path. Unpack has a second,
the box path, for a tile whose lanes are channels of ONE segment in a launch
that is aligned (T, L and Rp multiples of 4 floats, both pointers on 16
bytes, C >= ``TILE_LANES``): one thread loads the tile with the Tensor
Memory Accelerator (two 2-D boxes of 32 lanes in the 128-byte swizzle, zeros
past L) and every thread transposes 4 x 4 blocks in registers into 16-byte
stores along time. At the main path's geometry every tile of an unpack takes
it; the same path for pack measured no faster than the padded tile.

:func:`box_tiles` gives an unpack's count of box-path tiles as the CUDA
launcher computes it. The plain versions are ``pad`` / ``reshape`` /
``permute`` / ``contiguous``; they run for CPU tensors, or on request
(``use_kernels=False``), and are never a fallback for a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Rp is R = C*G rounded up to this many lanes: one warp's worth, so that
# every row of the time-major array starts on a 128-byte boundary.
LANE_MULTIPLE = 32
# gridDim.y of the kernels counts lane tiles; the limit is the first design's
# (32-lane tiles), kept
MAX_LANES = 65535 * 32
# A tile of csrc/relayout.cu (TL, TR): rows of the time-major array, lanes
# (mirrored here for the count of tiles; the numpy mirror of the schedule is
# tests/torch_port_util.relayout_tiles).
TILE_ROWS = 128
TILE_LANES = 64

# Launches of the pack / unpack kernel made by :func:`pack` / :func:`unpack`
# (and by nothing else) since the caller last set them to 0.
pack_launch_count = 0
unpack_launch_count = 0


def geometry(C: int, T: int, segments: int) -> tuple[int, int, int]:
    """(G, L, Rp) for ``segments`` requested segments: L = ceil(T/segments)
    samples per segment, G = ceil(T/L) segments actually needed (the last
    one ragged), Rp = C*G lanes rounded up to LANE_MULTIPLE."""
    if C < 1 or T < 1 or segments < 1:
        raise ValueError(f"bad relayout request: C={C}, T={T}, "
                         f"segments={segments}")
    L = -(-T // segments)
    G = -(-T // L)
    Rp = -(-C * G // LANE_MULTIPLE) * LANE_MULTIPLE
    return G, L, Rp


def _check(C: int, T: int, G: int, L: int, Rp: int) -> None:
    if min(C, T, G, L) < 1 or (G - 1) * L >= T or G * L < T:
        raise ValueError(
            f"segments do not tile the signal: C={C}, T={T}, G={G}, L={L} "
            "(need (G-1)*L < T <= G*L)")
    if Rp < C * G or Rp > MAX_LANES:
        raise ValueError(
            f"Rp={Rp} lanes: need C*G={C * G} <= Rp <= {MAX_LANES}")


def pack_plain(x: torch.Tensor, G: int, L: int, Rp: int) -> torch.Tensor:
    C, T = x.shape
    xp = torch.nn.functional.pad(x, (0, G * L - T))
    tm = xp.reshape(C, G, L).permute(2, 1, 0).reshape(L, G * C)
    return torch.nn.functional.pad(tm, (0, Rp - G * C)).contiguous()


def unpack_plain(tm: torch.Tensor, C: int, T: int, G: int, L: int
                 ) -> torch.Tensor:
    y = tm[:, :G * C].reshape(L, G, C).permute(2, 1, 0).reshape(C, G * L)
    return y[:, :T].contiguous()


def box_tiles(tm: torch.Tensor, y: torch.Tensor, C: int, T: int, G: int,
              L: int) -> tuple[int, int]:
    """(tiles on the box path, tiles on the masked path) of an unpack from
    ``tm`` into ``y``, as the CUDA launcher decides them
    (``relayout_unpack_box_tiles``; CUDA tensors only)."""
    if not (tm.is_cuda and y.is_cuda):
        raise ValueError("box_tiles counts a launch's tiles: CUDA tensors only")
    Rp = tm.shape[1]
    _check(C, T, G, L, Rp)
    fn = _build.launcher("relayout", "relayout_unpack_box_tiles",
                         [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    box = fn(C, T, G, L, Rp, tm.data_ptr(), y.data_ptr())
    if box < 0:
        raise ValueError(f"relayout refuses C={C}, G={G}, L={L}, Rp={Rp}")
    total = -(-L // TILE_ROWS) * -(-Rp // TILE_LANES)
    return box, total - box


def _launch(name: str, src: torch.Tensor, dst: torch.Tensor, C: int, T: int,
            G: int, L: int, Rp: int) -> None:
    fn = _build.launcher("relayout", f"relayout_{name}_launch",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), dst.data_ptr(), C, T, G, L, Rp,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"relayout {name} kernel launch failed with CUDA error {err} "
            f"(C={C}, T={T}, G={G}, L={L}, Rp={Rp})")


def pack(x: torch.Tensor, G: int, L: int, Rp: int,
         use_kernels: bool = True) -> torch.Tensor:
    """(C, T) natural -> (L, Rp) time-major, zeros wherever no sample lives.
    A CUDA tensor goes through the hand-written kernel, or the call raises;
    the plain version runs for a CPU tensor or with ``use_kernels=False``."""
    global pack_launch_count
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            "pack takes a contiguous (C, T) float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
    C, T = x.shape
    _check(C, T, G, L, Rp)
    if not (x.is_cuda and use_kernels):
        return pack_plain(x, G, L, Rp)
    tm = torch.empty((L, Rp), dtype=torch.float32, device=x.device)
    _launch("pack", x, tm, C, T, G, L, Rp)
    pack_launch_count += 1
    return tm


def unpack(tm: torch.Tensor, C: int, T: int, G: int, L: int,
           use_kernels: bool = True) -> torch.Tensor:
    """(L, Rp) time-major -> (C, T) natural: the inverse of :func:`pack`."""
    global unpack_launch_count
    if tm.dtype != torch.float32 or tm.dim() != 2 or not tm.is_contiguous() \
            or tm.shape[0] != L:
        raise ValueError(
            f"unpack takes a contiguous ({L}, Rp) float32 tensor, got "
            f"{tuple(tm.shape)} {tm.dtype} contiguous={tm.is_contiguous()}")
    Rp = tm.shape[1]
    _check(C, T, G, L, Rp)
    if not (tm.is_cuda and use_kernels):
        return unpack_plain(tm, C, T, G, L)
    y = torch.empty((C, T), dtype=torch.float32, device=tm.device)
    _launch("unpack", tm, y, C, T, G, L, Rp)
    unpack_launch_count += 1
    return y
