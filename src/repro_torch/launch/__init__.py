"""Launch layer: the serving entry point."""
