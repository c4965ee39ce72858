"""Core layer: engine config, device resolution, blocking, wav I/O,
generators, gain / dBV / dither utilities and meters."""
