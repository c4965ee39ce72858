"""PyTorch/CUDA port: resumable and segmented render, the cases of the JAX
package's tests (tests/test_resumable.py and
``test_render_segmented_matches_streamed_semantics`` of tests/test_engine.py)
in the port, on the CPU, and the checkpoint directory's layout against the
JAX package's."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyaudiodsptools_tpu as jx
import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu.core import block as jx_block
from pyaudiodsptools_tpu.engine.resumable import (
    render_resumable as jx_render_resumable)

from torch_port_util import snr_db

CPU = "cpu"


def _chain(cfg):
    o = pt.ops
    return pt.Chain([o.lowcut(cfg, 200.0, device=CPU),
                     o.compressor(cfg, -20.0, 0.5, device=CPU),
                     o.delay(cfg, 100.0, 2, device=CPU)], device=CPU)


def _jx_chain(cfg):
    o = jx.ops
    return jx.Chain([o.lowcut(cfg, 200.0), o.compressor(cfg, -20.0, 0.5),
                     o.delay(cfg, 100.0, 2)])


def _stream_fold(chain, blocks):
    st = chain.init_state(tuple(blocks.shape[:-2]))
    outs = []
    for i in range(blocks.shape[-2]):
        st, o = chain.step(st, blocks[..., i, :])
        outs.append(o)
    return torch.stack(outs, dim=-2)


def test_resumable_matches_direct(tmp_path):
    """Against the offline render within float tolerance (the JAX test's
    bar), and BIT-equal to the streaming fold, which it is."""
    cfg = pt.EngineConfig(44100, 512)
    chain = _chain(cfg)
    rng = np.random.default_rng(0)
    sig = (rng.standard_normal(512 * 20) * 0.4).astype(np.float32)
    blocks = pt.block.make_blocks(torch.from_numpy(sig), 512)

    direct = chain.render_blocks(blocks).numpy()
    ck = str(tmp_path / "ck")
    out = pt.render_resumable(chain, blocks, ck, segment_blocks=6)
    assert out.shape == blocks.shape and out.dtype == torch.float32
    np.testing.assert_allclose(direct, out.numpy(), atol=2e-6)
    assert torch.equal(out, _stream_fold(chain, blocks))

    # the directory a finished run leaves, file for file as the JAX package's
    jcfg = jx.EngineConfig(44100, 512)
    jck = str(tmp_path / "jck")
    want = np.asarray(jx_render_resumable(
        _jx_chain(jcfg), jx_block.make_blocks(jnp.asarray(sig), 512), jck,
        segment_blocks=6))
    assert snr_db(want, out.numpy()) >= 90.0
    assert sorted(os.listdir(ck)) == sorted(os.listdir(jck)) == [
        "meta.json", "out_00000.npy", "out_00001.npy", "out_00002.npy",
        "out_00003.npy", "state_00004.npz"]
    with open(os.path.join(ck, "meta.json")) as f, \
            open(os.path.join(jck, "meta.json")) as g:
        assert json.load(f) == json.load(g) == {
            "segment": 4, "shape": [20, 512], "state": "state_00004.npz"}
    with np.load(os.path.join(ck, "state_00004.npz")) as ours, \
            np.load(os.path.join(jck, "state_00004.npz")) as theirs:
        assert ours.files == theirs.files
        for k in ours.files[1:]:                # all but the FIR history
            if ours[k].dtype == np.float32:     # the delay's buffer
                assert snr_db(theirs[k], ours[k]) >= 90.0, k
            else:                               # the compressor's fields
                np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert np.load(os.path.join(ck, "out_00003.npy")).shape == (2, 512)


def test_resume_after_injected_crash(tmp_path):
    cfg = pt.EngineConfig(44100, 512)
    chain = _chain(cfg)
    rng = np.random.default_rng(1)
    sig = (rng.standard_normal((2, 512 * 18)) * 0.4).astype(np.float32)
    blocks = pt.block.make_blocks(torch.from_numpy(sig), 512)

    golden = pt.render_resumable(chain, blocks, str(tmp_path / "ref"),
                                 segment_blocks=4)
    ckpt = str(tmp_path / "crashy")
    with pytest.raises(RuntimeError, match="injected fault"):
        pt.render_resumable(chain, blocks, ckpt, segment_blocks=4,
                            stop_after=2)
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"segment": 2, "shape": [2, 18, 512],
                    "state": "state_00002.npz"}
    assert not os.path.exists(os.path.join(ckpt, "state_00001.npz"))
    # resume picks up from the checkpoint and matches the uninterrupted run
    resumed = pt.render_resumable(chain, blocks, ckpt, segment_blocks=4)
    assert torch.equal(golden, resumed)
    # a checkpoint of another shape is not resumed from
    other = pt.render_resumable(chain, blocks[:1], ckpt, segment_blocks=4)
    assert torch.equal(other, golden[:1])
    with pytest.raises(ValueError, match="segment_blocks"):
        pt.render_resumable(chain, blocks, ckpt, segment_blocks=0)


def test_render_segmented_matches_streamed_semantics():
    """Bounded-memory segmented render must equal the streaming fold
    (exactly: it IS the step path) and match the offline render within
    float tolerance."""
    cfg = pt.EngineConfig(44100, 512)
    o = pt.ops
    chain = pt.Chain([o.lowcut(cfg, 300.0, device=CPU),
                      o.compressor(cfg, -18.0, 0.6, device=CPU),
                      o.delay(cfg, 40.0, 2, device=CPU)], device=CPU)
    rng = np.random.default_rng(17)
    sig = (rng.standard_normal((2, 512 * 21 + 100)) * 0.3).astype(np.float32)

    seg = pt.render_segmented(chain, sig, cfg, segment_blocks=5)
    off = pt.render(chain, sig, cfg)
    assert seg.shape == off.shape == (2, 512 * 22)
    assert snr_db(off.numpy(), seg.numpy()) > 100.0
    blocks = pt.block.make_blocks(torch.from_numpy(sig), 512)
    stream = _stream_fold(chain, blocks).reshape(2, -1)
    assert torch.equal(seg, stream)
    trimmed = pt.render_segmented(chain, sig, cfg, segment_blocks=5,
                                  trim=True)
    assert torch.equal(trimmed, seg[:, :sig.shape[-1]])
    with pytest.raises(ValueError, match="segment_blocks"):
        pt.render_segmented(chain, sig, cfg, segment_blocks=0)
