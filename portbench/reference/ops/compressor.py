"""CreateCompressor: ``ratio`` is the gain held while over the threshold
(a multiplier in (0, 1)); the ramps run 1 -> ratio over ``attack_ms`` and
ratio -> 1 over ``release_ms``."""

import numpy as np

from portbench.reference import automaton


def apply(x, ctx, threshold_db: float, ratio: float, attack_ms: float,
          release_ms: float):
    return automaton.apply(
        x, ctx, threshold_db, 1.0,
        np.linspace(1.0, ratio, num=ctx.ms_to_samples(attack_ms)),
        np.linspace(ratio, 1.0, num=ctx.ms_to_samples(release_ms)))
