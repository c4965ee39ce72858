"""PyTorch/CUDA port: a lone waveshaper's offline (``ops/waveshapers.py``,
``kernels/tail.map_offline``).

A run of two or more tail effects fuses into one pass of the tail kernel
(``kernels/tail.py``); a lone saturator, soft clipper, harddistortion or
bitcrusher keeps its name and place in a chain, and its ``offline`` on a
CUDA tensor launches the same kernel with a one-stage ``map`` plan. The CPU
tests hold that the plain path is what it was: on a CPU tensor, with or
without ``use_kernels``, the offline is the plain function bit for bit and
launches nothing. The one-stage plans' schedule is held on the CPU by the
numpy mirror in ``test_torch_tail.py``.

The ``cuda`` tests (skipped without a card) hold the launch itself against
the plain function (>= 110 dB, the bitcrusher exactly) at a small and at the
main path's shape, one launch each; ``use_kernels=False`` on the card is the
plain function. They import no JAX, so that ``python -m pytest --noconftest
-m cuda tests/test_torch_lone_maps.py`` runs on a machine with a card and no
JAX (``tests/conftest.py`` imports JAX).
"""

import numpy as np
import pytest
import torch

import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu_torch.kernels import tail as pt_tail
from pyaudiodsptools_tpu_torch.ops import waveshapers as ws

from torch_port_util import snr_db

CFG = pt.EngineConfig(sample_rate=44100, block_size=512)

# map -> (factory arguments, plain function)
MAPS = {
    "softclipper": ((0.44,), ws._softclip),
    "saturator": ((-18.0, 1.5, "soft"), ws._saturate),
    "harddistortion": ((), ws._harddist),
    "bitcrusher": ((), ws._bitcrush),
}


def _effect(name, device):
    args, _ = MAPS[name]
    return getattr(pt.ops, name)(CFG, *args, device=device)


def _signal(shape, seed, device="cpu"):
    """Noise around full scale, with values past 1, an exact 0 and values
    either side of harddistortion's linear limit at the start."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device) * 0.5
    x.view(-1)[:6] = torch.tensor([1.4, -1.4, 0.0, 2.2, -0.79, 0.81])
    return x


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("name", list(MAPS))
def test_cpu_offline_is_the_plain_map(name, use_kernels):
    e = _effect(name, "cpu")
    x = _signal((3, 7, 512), seed=len(name))
    before = pt_tail.launch_count
    got = e.offline(e.params, x, use_kernels=use_kernels)
    assert pt_tail.launch_count == before
    assert got.dtype == torch.float32
    assert torch.equal(got, MAPS[name][1](e.params, x))
    # a chain of the lone map keeps its name and renders the same
    chain = pt.Chain([e], device="cpu")
    assert [f.name for f in chain.exec_effects] == [name]
    assert torch.equal(chain.render_blocks(x), got)
    assert pt_tail.launch_count == before


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 70, 512), (64, 323, 4096)])
@pytest.mark.parametrize("name", list(MAPS))
def test_cuda_lone_map_offline_launches_the_tail_kernel_on_card(name, shape):
    _need_card()
    e = _effect(name, "cuda")
    x = _signal(shape, seed=shape[0] + len(name), device="cuda")
    want = MAPS[name][1](e.params, x)
    before = pt_tail.launch_count
    got = e.offline(e.params, x)
    torch.cuda.synchronize()
    assert pt_tail.launch_count == before + 1
    assert got.shape == x.shape and got.dtype == torch.float32
    if name == "bitcrusher":
        # one ulp before the floor division is a whole 1/64 step: exact
        assert torch.equal(got, want)
    else:
        assert snr_db(want.cpu().numpy(), got.cpu().numpy()) >= 110.0
    plain = e.offline(e.params, x, use_kernels=False)
    assert pt_tail.launch_count == before + 1
    assert torch.equal(plain, want)
    # a strided view is taken as its values
    view = x[:2, ::2]
    assert torch.equal(e.offline(e.params, view),
                       e.offline(e.params, view.contiguous()))
