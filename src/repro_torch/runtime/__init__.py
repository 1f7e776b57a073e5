"""Host-side runtime: the serving engine's request scheduler and KV block
allocator, and the training loop's fault tolerance (straggler detection,
preemption handling, restore-and-retry)."""
from repro_torch.runtime.fault import (PreemptionHandler, Retrier,
                                       StragglerDetector)  # noqa: F401
