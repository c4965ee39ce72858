"""The worst rank's idle share of its traced window, in percent."""


def read(rec):
    if rec.loop != "sharded" or not rec.ranks:
        return None
    return max(r["profile"]["idle_pct"] for r in rec.ranks)
