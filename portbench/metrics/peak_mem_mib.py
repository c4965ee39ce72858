"""``torch.cuda.max_memory_reserved()`` over set-up and window, MiB; the
largest rank's in a sharded run."""


def read(rec):
    if not rec.peak_reserved:
        return None
    return rec.peak_reserved / 2.0 ** 20
