"""Core layer: engine config, device resolution, blocking, wav I/O."""
