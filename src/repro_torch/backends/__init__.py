"""Backend plugin package (the paper's "extensibility to new architectures").

Importing this package registers every shipped backend with
``repro_torch.core.backend``.  To add an architecture, drop a module here
that builds a :class:`repro_torch.core.backend.Backend` and calls
``register_backend`` / ``register_kernel`` at import time — core compiler
files never enumerate backend names.  Registration is idempotent, so
re-imports are safe.
"""
from repro_torch.backends import builtin as _builtin    # noqa: F401
from repro_torch.backends import loops as _loops        # noqa: F401
from repro_torch.backends import openmp as _openmp      # noqa: F401
