"""Machine-peaks microbenchmarks on the card — the port's counterpart of
the reference's ``benchmarks/machine_peaks.py``: measure the roofline
ceilings once per host and persist them for the cost model and the
dry-run.

Each ceiling has its microkernel, all on the CUDA device:

* ``bandwidth_bytes_per_s`` — HBM streaming: y = x + 1 over an f32
  array far past the 50 MB L2 (one read + one write an element);
* ``scratch_bandwidth_bytes_per_s`` — the same stream over a working
  set that stays in L2 after the first sweep;
* ``flops_per_s`` — a dense f32 matmul with TF32 off (the FP32 pipes,
  the rate the cost model ranks candidates by);
* ``bf16_flops_per_s`` — a dense bf16 matmul (the tensor cores, the
  dry-run's compute ceiling);
* ``launch_overhead_s`` — device time per launch of a one-element
  kernel issued back to back;
* ``dispatch_overhead_s`` — host time to issue one eager op.

Device times are CUDA events around a run of launches that the host
queued while the card spun (so its issue time stays out; a run stays
under the card's queue of pending launches), the median over rounds of
the mean a launch, after an untimed warm-up; the host time is
``time.perf_counter`` over the issue alone.  The result is written by
``core.costmodel.save_peaks`` as ``machine_peaks_<fingerprint>.json``
under the tuning-cache directory (``$REPRO_TUNE_CACHE`` or
``~/.cache/repro-tune``), fingerprinted on host + torch + CUDA + the
card's name, so a measurement never leaks to another machine.  Without
a card it raises: no number here comes from the CPU.

CLI::

    PYTHONPATH=src python -m repro_torch.benchmarks.machine_peaks          # measure + persist
    PYTHONPATH=src python -m repro_torch.benchmarks.machine_peaks --smoke  # tiny sizes
    PYTHONPATH=src python -m repro_torch.benchmarks.machine_peaks --print  # show, don't write
"""
from __future__ import annotations

import statistics
import time


def _device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("machine_peaks measures the CUDA card, and torch "
                           "sees none")
    return torch.device("cuda")


# a host issue of one eager launch takes ~10 µs; the card spins this long
# a launch queued ahead of the start event, so the timed launches run
# back to back and the time is the device's alone
_ISSUE_S = 20e-6
_CLOCK_HZ = 2.0e9           # spin cycles a second (the SM clock, ~1.98 GHz)


def _event_seconds(fn, reps: int, rounds: int, launches: int = 1) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``reps`` calls
    of ``fn`` (``launches`` kernels a call), a call (one untimed warm-up
    first).  Before each round the card spins while the host queues the
    round's launches, so the host's issue time stays out."""
    import torch
    fn()
    torch.cuda.synchronize()
    samples = []
    spin = int(reps * launches * _ISSUE_S * _CLOCK_HZ)
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / 1e3 / reps)
    return statistics.median(samples)


def measure_bandwidth(n_elems: int, reps: int, rounds: int) -> float:
    """HBM streaming rate: y = x + 1 over n f32 elements."""
    import torch
    x = torch.randn(n_elems, device=_device())
    y = torch.empty_like(x)
    sec = _event_seconds(lambda: torch.add(x, 1.0, out=y), reps, rounds)
    return 2.0 * n_elems * 4 / sec


def measure_scratch_bandwidth(n_elems: int, reps: int, rounds: int,
                              sweeps: int = 16) -> float:
    """L2 rate: ``sweeps`` passes of y = x + 1 over a working set the L2
    holds, so after the first every access hits the cache."""
    import torch
    x = torch.randn(n_elems, device=_device())
    y = torch.empty_like(x)

    def f():
        for _ in range(sweeps):
            torch.add(x, 1.0, out=y)
    sec = _event_seconds(f, reps, rounds, launches=sweeps)
    return 2.0 * n_elems * 4 * sweeps / sec


def measure_flops(n: int, reps: int, rounds: int, dtype=None) -> float:
    """Dense matmul rate: an n × n product is 2n³ operations.  f32 runs
    with TF32 off, so it measures the FP32 pipes."""
    import torch
    dtype = dtype or torch.float32
    dev = _device()
    a = torch.randn(n, n, device=dev).to(dtype)
    b = torch.randn(n, n, device=dev).to(dtype)
    c = torch.empty(n, n, device=dev, dtype=dtype)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sec = _event_seconds(lambda: torch.matmul(a, b, out=c), reps,
                             rounds)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return 2.0 * n ** 3 / sec


def measure_launch_overhead(reps: int, rounds: int) -> float:
    """Device time a launch of a one-element kernel, queued back to back
    (the host ahead of the card): what a kernel boundary costs the
    card."""
    import torch
    x = torch.zeros(1, device=_device())
    return _event_seconds(lambda: x.add_(1.0), reps, rounds)


def measure_dispatch_overhead(reps: int, rounds: int) -> float:
    """Host time to issue one eager op on a card tensor (the issue alone;
    the device catches up after the clock stops)."""
    import torch
    x = torch.zeros(1, device=_device())
    x.add_(1.0)
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            x.add_(1.0)
        samples.append((time.perf_counter() - t0) / reps)
        torch.cuda.synchronize()
    return statistics.median(samples)


def measure_peaks(smoke: bool = False):
    import torch

    from repro_torch.core.costmodel import MachinePeaks, machine_fingerprint
    if smoke:
        stream_n, scratch_n, mm_n = 2 ** 20, 2 ** 16, 1024
        reps, rounds = 5, 3
    else:
        # 1 GiB streamed (far past the 50 MB L2); 16 MiB in L2 (x and y)
        stream_n, scratch_n, mm_n = 2 ** 28, 2 ** 21, 8192
        reps, rounds = 20, 5
    return MachinePeaks(
        bandwidth_bytes_per_s=measure_bandwidth(stream_n, reps, rounds),
        scratch_bandwidth_bytes_per_s=measure_scratch_bandwidth(
            scratch_n, reps, rounds),
        flops_per_s=measure_flops(mm_n, max(reps // 4, 2), rounds),
        bf16_flops_per_s=measure_flops(mm_n, reps, rounds, torch.bfloat16),
        launch_overhead_s=measure_launch_overhead(reps * 20, rounds),
        dispatch_overhead_s=measure_dispatch_overhead(reps * 50, rounds),
        fingerprint=machine_fingerprint(),
        measured=True)


def report(peaks) -> list:
    """The ceilings as ``machine_peaks/<name>,<value>,`` lines."""
    return [f"machine_peaks/bandwidth_gb_s,"
            f"{peaks.bandwidth_bytes_per_s / 1e9:.2f},",
            f"machine_peaks/scratch_bandwidth_gb_s,"
            f"{peaks.scratch_bandwidth_bytes_per_s / 1e9:.2f},",
            f"machine_peaks/f32_gflops,{peaks.flops_per_s / 1e9:.2f},",
            f"machine_peaks/bf16_gflops,{peaks.bf16_flops_per_s / 1e9:.2f},",
            f"machine_peaks/launch_overhead_us,"
            f"{peaks.launch_overhead_s * 1e6:.2f},",
            f"machine_peaks/dispatch_overhead_us,"
            f"{peaks.dispatch_overhead_s * 1e6:.2f},"]


def main(argv=None) -> int:
    import argparse

    from repro_torch.core import costmodel
    p = argparse.ArgumentParser(
        description="measure the card's roofline peaks and persist them "
                    "for the cost model and the dry-run")
    p.add_argument("--smoke", action="store_true",
                   help="tiny sizes (a quick check; numbers are NOT peaks)")
    p.add_argument("--print", dest="show_only", action="store_true",
                   help="measure and print, don't persist")
    p.add_argument("--force", action="store_true",
                   help="re-measure even if a persisted file exists")
    args = p.parse_args(argv)

    existing = costmodel.load_peaks()
    if existing.measured and not (args.force or args.show_only):
        print(f"# peaks already measured for fingerprint "
              f"{existing.fingerprint} (use --force to re-measure)")
        peaks = existing
    else:
        peaks = measure_peaks(smoke=args.smoke)
        if not args.show_only:
            print(f"# wrote {costmodel.save_peaks(peaks)}")
    import torch
    print(f"# {torch.cuda.get_device_name(0)}")
    for line in report(peaks):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
