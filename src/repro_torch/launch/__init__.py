"""Launch layer: the serving and training entry points."""
