"""The dynamics walks a job took, state walk included, as the captured
render's device count gives them (``CapturedRender.walks()``), mean over
the window's jobs."""

from portbench.readers import mean


def read(rec):
    if rec.loop != "offline" or not rec.geometry.get("dynamics_ops"):
        return None
    return mean(rec.walks)
