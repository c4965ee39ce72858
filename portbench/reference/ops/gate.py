"""CreateGate: the signal scaled by ``depth`` (closed), opened by the
compressor's automaton with ramps 1 -> 1/depth over ``attack_ms`` and
1/depth -> 1 over ``release_ms``; the mask comes from the unscaled
input."""

import numpy as np

from portbench.reference import automaton


def apply(x, ctx, threshold_db: float, depth: float, attack_ms: float,
          release_ms: float):
    return automaton.apply(
        x, ctx, threshold_db, depth,
        np.linspace(1.0, 1.0 / depth, num=ctx.ms_to_samples(attack_ms)),
        np.linspace(1.0 / depth, 1.0, num=ctx.ms_to_samples(release_ms)))
