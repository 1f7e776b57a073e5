"""repro_torch — the PyTorch + CUDA port of the LAPIS-style compiler in
``repro`` (the JAX reference package).  Imports torch and never JAX or
the reference; entry points run on the card unless asked for the CPU."""
