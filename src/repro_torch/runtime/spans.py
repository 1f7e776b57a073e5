"""Named spans around the program's own phases, recorded only while a
``torch.profiler`` session is active.

``span(name)`` is a context manager.  With no profiler running it
returns one shared null context after a single check
(``torch.autograd._profiler_enabled()``): no allocation, no clock read,
no device sync.  Under a profiler each span records its name, its start
and end on ``time.time_ns()`` (the base of the profiler's own host and
device timestamps), the index of the span it opened inside (-1 for
none) and the thread that opened it.  A span never reads a tensor or
synchronises the device, so on the card it holds host time: the kernels
launched inside it are found by their launch time, not by their run.

To read them: open ``torch.profiler.profile``, run the program, then
call :func:`take`, which returns every span recorded since the last
call and clears the list.  Join a kernel to the innermost span whose
interval holds its launch event, and an idle gap of the card to the
span the host was in at the gap's midpoint, all on ``time.time_ns()``;
match on time alone, since autograd's device thread launches a
backward's kernels while the calling thread waits inside its span.
Call :func:`take` outside any open span (a parent's index refers to the
list it is returned in).

``count(name, n)`` adds a host integer the caller already holds to a
named counter, under the same rule (nothing while no profiler runs,
nothing read from the device); :func:`take_counts` returns the counters
and clears them.  The MoE counts its rows so: ``moe.slot_rows`` (the
rows its expert products are given: T · k over the routed rows alone,
G · E · C over the padded buffers) and ``moe.routed_rows`` (the tokens'
choices, T · k).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, List

import torch

_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_spans: List["Span"] = []
_lock = threading.Lock()
_open = threading.local()        # per thread: indices of its open spans
_counts: collections.Counter = collections.Counter()


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int = -1        # -1 while the span is open
    parent: int = -1        # index of the enclosing span in the same list
    thread: int = 0


class _Recording:
    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.span = Span(self.name, time.time_ns(),
                         parent=stack[-1] if stack else -1,
                         thread=threading.get_ident())
        with _lock:
            stack.append(len(_spans))
            _spans.append(self.span)
        return self

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        _open.stack.pop()
        return False


def span(name: str):
    """A span named ``name`` while a profiler is active, else a shared
    null context."""
    if not _enabled():
        return _NULL
    return _Recording(name)


def take() -> List[Span]:
    """Every span recorded since the last call, in the order they
    opened; the list is cleared."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return out


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while a profiler is active."""
    if _enabled():
        with _lock:
            _counts[name] += int(n)


def take_counts() -> Dict[str, int]:
    """Every counter since the last call; the counters are cleared."""
    with _lock:
        out = dict(_counts)
        _counts.clear()
    return out
