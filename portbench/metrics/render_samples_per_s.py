"""Channel-samples of unpadded input in every job completed in the
window, over the window's seconds (host clock): offline and sharded
renders."""


def read(rec):
    if rec.loop not in ("offline", "sharded") or rec.window_s <= 0:
        return None
    return rec.samples / rec.window_s
