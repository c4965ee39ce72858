"""PyTorch/CUDA port: an FIR before ``harddistortion``, the rule that pins it.

``harddistortion`` takes its sign from ``x >= 0`` in both packages: +0 maps
to +0.951, -3e-8 to -0.951. Offline, the port's FIR writes EXACT zeros in
the first ``lead`` output samples (its output delay); the JAX package's two
paths and the port's own stream leave about 1e-7 of rounding noise there.
No implementation matches noise bits, so the rule is: after an FIR, an op
with a jump at 0 differs from the JAX package in the FIR's lead and wherever
its input lies within rounding of zero, and agrees everywhere else.

The tests hold that on the CPU (the port's plain versions, the JAX package's
plain XLA paths): outside the first ``lead + 1`` samples and the samples
whose ``harddistortion`` input lies within 1e-6 of zero in any of the three
renders, the port's offline render is >= 90 dB from the JAX offline render
and from its own stream; the offline lead is ``harddistortion(+0)`` exactly.
"""

import numpy as np
import pytest
import torch

import pyaudiodsptools_tpu as jx
import pyaudiodsptools_tpu_torch as pt

from torch_port_util import snr_db

CPU = "cpu"
NEAR_ZERO = 1e-6
DB = 90.0


def _fir(pkg, cfg, which, **kw):
    if which == "lowcut":
        return pkg.ops.lowcut(cfg, 120.0, **kw)
    return pkg.ops.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5,
                               **kw)


def _stream(chain, cfg, x, B):
    sp = pt.StreamProcessor(chain, cfg, (x.shape[0],))
    return np.concatenate([sp.process(x[:, i * B:(i + 1) * B])
                           for i in range(x.shape[1] // B)], -1)


@pytest.mark.parametrize("which,B,blocks", [("lowcut", 512, 40),
                                            ("eq3band_fft", 512, 40),
                                            ("eq3band_fft", 4096, 6)])
def test_fir_then_harddistortion_agrees_outside_the_lead(which, B, blocks):
    rng = np.random.default_rng(B + len(which))
    x = (rng.standard_normal((2, blocks * B)) * 0.3).astype(np.float32)
    jcfg, pcfg = jx.EngineConfig(44100, B), pt.EngineConfig(44100, B)
    jfir, pfir = _fir(jx, jcfg, which), _fir(pt, pcfg, which, device=CPU)
    phd = pt.ops.harddistortion(pcfg, device=CPU)
    jchain = jx.Chain([jfir, jx.ops.harddistortion(jcfg)])
    pchain = pt.Chain([pfir, phd], device=CPU)
    pfir_chain = pt.Chain([pfir], device=CPU)

    offline = pt.render(pchain, x, pcfg).numpy()
    jax_offline = np.asarray(jx.render(jchain, x, jcfg))
    streamed = _stream(pchain, pcfg, x, B)
    # the harddistortion inputs of the three renders
    inputs = (pt.render(pfir_chain, x, pcfg).numpy(),
              np.asarray(jx.render(jx.Chain([jfir]), x, jcfg)),
              _stream(pfir_chain, pcfg, x, B))

    lead = pfir.params.lead
    assert lead > 0
    # offline, the lead is the FIR's exact zero through harddistortion
    assert not inputs[0][:, :lead].any()
    plus_zero = phd.step(phd.params, (), torch.zeros(1))[1].numpy()[0]
    # +0 counts as positive: 0.8 + 0.2 sin((0 - 0.8) / 0.2)
    assert abs(plus_zero - (0.8 + 0.2 * np.sin(-4.0))) < 1e-6
    np.testing.assert_array_equal(offline[:, :lead],
                                  np.full((2, lead), plus_zero))

    keep = np.ones(offline.shape, dtype=bool)
    keep[:, :lead + 1] = False
    for y in inputs:
        keep &= np.abs(y) >= NEAR_ZERO
    # the mask takes the lead and a handful of samples besides
    assert keep.sum() >= offline.size - 2 * (lead + 1) - offline.size // 100
    assert snr_db(jax_offline[keep], offline[keep]) >= DB
    assert snr_db(streamed[keep], offline[keep]) >= DB
