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
