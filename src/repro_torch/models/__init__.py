"""Model functions written on ``repro_torch.core.ops``, so they trace
through the compiler (the reference's ``models`` package, slice by
slice)."""
