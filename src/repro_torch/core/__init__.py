"""The compiler core: IR, passes, backends registry, emitter, pipeline."""
