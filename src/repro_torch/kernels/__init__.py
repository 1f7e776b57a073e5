"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain torch
versions.  Modules import without a card or a compiler: a kernel is
built (nvcc) and loaded (ctypes) at its first launch."""
