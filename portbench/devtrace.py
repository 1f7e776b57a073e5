"""The profiler's trace of a window, reduced to what the metric readers
and the result's ``breakdown`` need.

Device activity (kernels, copies, sets) comes from CUPTI through the
profiler; host activity is the CPU ops and the ``portbench.*`` ranges
the entries open around their calls into the program.  A kernel is tied
to the host op that launched it through the launch's correlation id.
"""
from __future__ import annotations

import bisect
import collections
import heapq
from typing import Callable, Iterable, Optional

_COPIES = ("Memcpy", "Memset")
SPAN = "portbench."


class Trace:
    def __init__(self, device: list, host: list, launches: dict,
                 window_s: float, main_tid: Optional[int]):
        self.device = sorted(device)        # (start_ns, end_ns, name, corr)
        self.host = sorted(host)            # (start_ns, end_ns, name, tid)
        self.launches = launches            # corr -> launch start_ns
        self.window_s = float(window_s)
        self.main_tid = main_tid
        self.kernels = [d for d in self.device
                        if not d[2].startswith(_COPIES)]
        self.busy_s = sum(e - s for s, e in self._merged()) / 1e9

    @classmethod
    def from_profile(cls, prof, window_s: float, on_card: bool) -> "Trace":
        """The window's trace; with the CUDA activity alone (no host ops)
        the host labels and launches are left empty."""
        device, host, launches = [], [], {}
        main_tid = None
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            name = e.name()
            if str(e.device_type()).endswith("CUDA"):
                if not name.startswith(SPAN):   # the ranges' device shadows
                    device.append((start, end, name, e.correlation_id()))
            elif name.startswith(("cuda", "cu")) and "Launch" in name:
                launches[e.correlation_id()] = (start, e.start_thread_id())
            else:
                tid = e.start_thread_id()
                host.append((start, end, name, tid))
                if name.startswith(SPAN):
                    main_tid = tid
        if on_card and not device:
            raise RuntimeError("the profiler recorded no device activity")
        return cls(device, host, launches, window_s, main_tid)

    # -- device time -------------------------------------------------------
    def _merged(self) -> list:
        out = []
        for s, e, _, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def kernel_s(self, pick: Callable[[str], bool],
                 corrs: Optional[set] = None) -> float:
        """Seconds of the kernels whose name ``pick`` accepts (and, with
        ``corrs``, whose launch is among them)."""
        return sum(e - s for s, e, n, c in self.kernels
                   if pick(n) and (corrs is None or c in corrs)) / 1e9

    def kernel_count(self, pick: Callable[[str], bool] = lambda n: True
                     ) -> int:
        return sum(1 for k in self.kernels if pick(k[2]))

    def launched_under(self, op_names: Iterable[str]) -> set:
        """Correlation ids of the device activity launched while a host
        op named in ``op_names`` ran on the launching thread."""
        names = set(op_names)
        spans = collections.defaultdict(list)
        for s, e, n, tid in self.host:
            if n in names:
                spans[tid].append((s, e))
        out = set()
        for corr, (t, tid) in self.launches.items():
            iv = spans.get(tid)
            if not iv:
                continue
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                out.add(corr)
        return out

    # -- breakdown ---------------------------------------------------------
    def _host_labels(self, points: list) -> list:
        """For each time in ``points`` (sorted), what the main thread was
        doing: its outermost ``portbench.*`` range and innermost op."""
        events = [h for h in self.host if h[3] == self.main_tid]
        out, stack, i = [], [], 0
        for t in points:
            while i < len(events) and events[i][0] <= t:
                s, e, n, _ = events[i]
                while stack and stack[-1][1] < s:
                    stack.pop()
                stack.append((s, e, n))
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            live = [n for s, e, n in stack if e >= t]
            span = next((n for n in live if n.startswith(SPAN)), "host")
            inner = live[-1] if live and live[-1] != span else ""
            out.append(f"{span}/{inner}" if inner else span)
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_op = collections.Counter()
        for s, e, n, _ in self.device:
            by_op[n[:160]] += (e - s) / 1e9
        merged = self._merged()
        gaps = [(merged[i][1], merged[i + 1][0])
                for i in range(len(merged) - 1)]
        labels = self._host_labels([(a + b) // 2 for a, b in gaps])
        idle = collections.Counter()
        for (a, b), lab in zip(gaps, labels):
            idle[lab] += (b - a) / 1e9
        return {"device_ops": [[n, t] for n, t in
                               heapq.nlargest(top, by_op.items(),
                                              key=lambda kv: kv[1])],
                "idle_gaps": [[n, t] for n, t in
                              heapq.nlargest(top, idle.items(),
                                             key=lambda kv: kv[1])]}
