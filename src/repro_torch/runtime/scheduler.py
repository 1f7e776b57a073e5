"""Serving-engine scheduling: request queue, block allocator, continuous
(in-flight) batching admission.

Pure host-side bookkeeping — no tensors in this module (a copy of the
reference's ``runtime/scheduler.py``).  The launch layer
(:mod:`repro_torch.launch.serve`) owns the device loop; this module decides
*which* request occupies *which* decode slot backed by *which* KV blocks,
so the policy is testable without compiling a model.

Design (vLLM/Orca-shaped, scaled to the repro):

* :class:`BlockAllocator` — a refcounted free list over the shared KV
  block pool.  Block 0 is never handed out: it is the **scrap block**
  every inactive slot's append lands in (their page-table rows are all
  zero), which keeps the compiled decode step branch-free over slot
  activity.  Refcounts > 1 mark blocks mapped copy-on-write into several
  page tables by the prefix-sharing tier.
* :class:`PrefixIndex` — a content-hashed map from prompt-prefix blocks
  to pool block ids, so requests with a common leading prompt share the
  physical KV blocks (vLLM's prefix caching).  Chain-keyed per block:
  a block matches only when every earlier block of the prompt matched.
* :class:`Request` — one generation request: prompt, target length,
  arrival time, and the per-token emission timestamps the latency
  percentiles are computed from.
* :class:`ContinuousScheduler` — FCFS admission into a fixed set of
  decode slots.  ``max_prefill_per_step`` bounds how many prefills may
  be admitted between two decode steps — the prefill/decode
  disaggregation knob that bounds decode-step stalls under bursts.
  ``lazy=True`` switches from reserve-up-front (the whole ``prompt+gen``
  block budget at admission) to lazy allocation: admit on prompt-block
  availability, grow one block at a time as generation crosses block
  boundaries (:meth:`prepare_append`), and let the engine preempt the
  lowest-priority in-flight request to a swap pool under pressure
  (:meth:`pick_victim` / :meth:`preempt`).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


class PagePoolExhausted(RuntimeError):
    """No free KV blocks remain for an allocation that needs them.

    Raised by :meth:`BlockAllocator.alloc` when a block demand exceeds
    the free list; the message carries the requested count and the
    live/free pool state (and, when raised through the scheduler, the
    per-slot block usage) so pool-pressure failures are diagnosable.
    The scheduler treats admission-time exhaustion as back-pressure (the
    request waits in the pending queue); under lazy allocation the
    engine answers growth-time exhaustion with preemption/swapping."""


class BlockAllocator:
    """Refcounted free-list allocator over block ids ``1 .. n_blocks-1``
    of the shared pool (block 0 is the reserved scrap block).

    ``alloc`` hands out private blocks (refcount 1); ``share`` adds a
    reference to an already-live block (copy-on-write prefix sharing);
    ``release`` drops one reference per id and returns the ids that
    actually went free — a block mapped into several page tables
    survives until its last reference is dropped."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (block 0 is scrap)")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._rc: Dict[int, int] = {}
        # telemetry (`telemetry()`; `launch.serve.serve_paged` returns it
        # in its result under "telemetry" -> "allocator")
        self.peak_in_use = 0
        self.total_allocs = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    def refcount(self, bid: int) -> int:
        return self._rc.get(bid, 0)

    def shared_blocks(self) -> tuple:
        """Block ids currently mapped into more than one page table
        (refcount > 1) — the allocator's copy-on-write invariant,
        exported for static checking: a compiled step that writes one
        of these must declare it (``shared_block_ids`` attr on
        ``paged.append``/``paged.copy``) so the ``check_paged_alias``
        analysis can verify a fork precedes the write."""
        return tuple(sorted(b for b, rc in self._rc.items() if rc > 1))

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} KV block(s), {len(self._free)} free / "
                f"{self.n_live} live (pool of {self.n_blocks}, block 0 "
                f"reserved; peak in use {self.peak_in_use})")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._rc[b] = 1
        self.total_allocs += n
        self.peak_in_use = max(self.peak_in_use, self.n_live)
        return out

    def share(self, ids: List[int]) -> None:
        """Add one reference per id (block mapped into another table)."""
        for b in ids:
            if self._rc.get(b, 0) < 1:
                raise ValueError(f"cannot share free block {b}")
            self._rc[b] += 1

    def release(self, ids: List[int]) -> List[int]:
        """Drop one reference per id; return the ids that went free."""
        freed = []
        for b in ids:
            rc = self._rc.get(b, 0)
            if rc < 1:
                raise ValueError(f"double free of block {b}")
            if rc == 1:
                del self._rc[b]
                self._free.append(b)
                freed.append(b)
            else:
                self._rc[b] = rc - 1
        return freed

    def telemetry(self) -> dict:
        """Allocator counters for the bench record."""
        allocatable = self.n_blocks - 1
        return {"n_blocks": self.n_blocks,
                "peak_blocks_in_use": self.peak_in_use,
                "peak_utilization": round(self.peak_in_use
                                          / max(allocatable, 1), 4),
                "total_allocs": self.total_allocs}


class PrefixIndex:
    """Content-hashed prompt-prefix → block-id index (CoW sharing tier).

    Keys are chain-interned: block *i* of a prompt is keyed by (key of
    block *i-1*, the tokens in block *i*), so a block can only match when
    the entire prefix before it matched — exactly the invariant that
    makes sharing the underlying KV safe (K/V at position *p* depends
    only on tokens ``<= p``).  Full blocks match any longer prompt with
    the same leading tokens; a *partial* tail block matches only a
    prompt that ends exactly there (its remaining positions are pristine
    zeros until its owner appends — at which point the entry is dropped,
    see :meth:`ContinuousScheduler.prepare_append`)."""

    _ROOT = 0

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._intern: Dict[Tuple[int, tuple], int] = {}
        self._next_key = 1
        self._full: Dict[int, int] = {}           # key id -> block id
        self._partial: Dict[Tuple[int, tuple], int] = {}
        self._owner: Dict[int, tuple] = {}        # block id -> entry ref

    def _chunks(self, prompt) -> Tuple[List[tuple], tuple]:
        toks = [int(t) for t in prompt]
        bs = self.block_size
        full = [tuple(toks[i:i + bs])
                for i in range(0, (len(toks) // bs) * bs, bs)]
        tail = tuple(toks[(len(toks) // bs) * bs:])
        return full, tail

    def match(self, prompt) -> List[int]:
        """Longest shared leading run of this prompt's blocks, in block
        order.  May include a partial tail block only on an exact match
        of the prompt's own tail."""
        full, tail = self._chunks(prompt)
        out: List[int] = []
        parent = self._ROOT
        for chunk in full:
            kid = self._intern.get((parent, chunk))
            if kid is None or kid not in self._full:
                return out
            out.append(self._full[kid])
            parent = kid
        if tail:
            bid = self._partial.get((parent, tail))
            if bid is not None:
                out.append(bid)
        return out

    def insert(self, prompt, blocks: List[int]) -> None:
        """Register a prompt's blocks (first writer wins per entry)."""
        full, tail = self._chunks(prompt)
        parent = self._ROOT
        for i, chunk in enumerate(full):
            kid = self._intern.get((parent, chunk))
            if kid is None:
                kid = self._next_key
                self._next_key += 1
                self._intern[(parent, chunk)] = kid
            if kid not in self._full and i < len(blocks):
                self._full[kid] = blocks[i]
                self._owner[blocks[i]] = ("full", kid)
            parent = kid
        if tail and len(blocks) > len(full):
            key = (parent, tail)
            if key not in self._partial:
                self._partial[key] = blocks[len(full)]
                self._owner[blocks[len(full)]] = ("partial", key)

    def indexed(self, bid: int) -> bool:
        return bid in self._owner

    def drop_block(self, bid: int) -> None:
        """Forget the entry naming ``bid`` (block freed, or its content
        diverged from the indexed prefix)."""
        ref = self._owner.pop(bid, None)
        if ref is None:
            return
        kind, key = ref
        if kind == "full":
            self._full.pop(key, None)
        else:
            self._partial.pop(key, None)


@dataclasses.dataclass
class Request:
    """One generation request and its per-token telemetry."""

    rid: int
    prompt: "object"               # 1-D int array of token ids
    gen_len: int
    arrival: float                 # seconds on the serving clock
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_times: List[float] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    blocks: List[int] = dataclasses.field(default_factory=list)
    swap_blocks: List[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0           # chunked-prefill progress (tokens done)
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.gen_len

    def blocks_needed(self, block_size: int) -> int:
        """Total fixed-size blocks this request's full context occupies."""
        return -(-(self.prompt_len + self.gen_len) // block_size)

    def prompt_blocks_needed(self, block_size: int) -> int:
        """Blocks covering the prompt alone (the lazy admission budget)."""
        return -(-self.prompt_len // block_size)

    def stored_positions(self) -> int:
        """KV positions currently materialized for this request: the
        prompt plus every generated token whose K/V a decode append has
        written (the newest token's K/V lands on the *next* step)."""
        return self.prompt_len + max(len(self.tokens) - 1, 0)


class ContinuousScheduler:
    """FCFS continuous-batching admission over ``n_slots`` decode slots.

    Every decode step the launch loop calls :meth:`admit` (refilling
    freed slots, bounded by ``max_prefill_per_step``) and, per finished
    request, :meth:`finish` (which frees the slot and its blocks).

    With ``lazy=False`` (reserve-up-front) a request is only admitted
    when a slot AND its whole ``prompt+gen`` block budget are available,
    which keeps mid-stream appends infallible.  With ``lazy=True`` only
    the prompt blocks are reserved at admission; the engine calls
    :meth:`prepare_append` before each decode step to grow a slot's
    table when generation crosses a block boundary, and resolves
    growth-time :class:`PagePoolExhausted` by preempting the
    lowest-priority in-flight request (:meth:`pick_victim` /
    :meth:`preempt`) to a swap pool — pool exhaustion becomes
    backpressure instead of an admission ceiling.

    A :class:`PrefixIndex` (``prefix_index=``) turns on copy-on-write
    prompt sharing: admission maps matching leading prompt blocks into
    the new request's table with bumped refcounts, and
    :meth:`prepare_append` returns a fork instruction whenever an append
    would write into a block some other table still references.
    """

    def __init__(self, n_slots: int, allocator: BlockAllocator,
                 block_size: int, max_blocks_per_slot: int,
                 max_prefill_per_step: int = 1, lazy: bool = False,
                 prefix_index: Optional[PrefixIndex] = None):
        self.n_slots = n_slots
        self.allocator = allocator
        self.block_size = block_size
        self.max_blocks_per_slot = max_blocks_per_slot
        self.max_prefill_per_step = max(1, max_prefill_per_step)
        self.lazy = lazy
        self.prefix = prefix_index
        self.pending: Deque[Request] = deque()
        self.active: List[Optional[Request]] = [None] * n_slots
        # telemetry (`telemetry()`; `launch.serve.serve_paged` returns it
        # in its result under "telemetry")
        self.preemptions = 0
        self.forks = 0
        self.shared_block_hits = 0
        self.peak_active = 0

    # -- queue ---------------------------------------------------------------
    def submit(self, req: Request) -> None:
        need = req.blocks_needed(self.block_size)
        if need > self.max_blocks_per_slot:
            raise PagePoolExhausted(
                f"request {req.rid} needs {need} blocks > page table "
                f"width {self.max_blocks_per_slot}")
        if need > self.allocator.n_blocks - 1:
            # could never be satisfied even by an empty pool — an error,
            # not back-pressure (back-pressure would spin forever); true
            # in the lazy tier too: a request's own max context must fit
            # the pool simultaneously, swap or no swap
            raise PagePoolExhausted(
                f"request {req.rid} needs {need} blocks but the pool "
                f"holds only {self.allocator.n_blocks - 1} allocatable")
        self.pending.append(req)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.active)

    def has_work(self) -> bool:
        return bool(self.pending) or self.n_active > 0

    def describe_usage(self) -> str:
        """Per-slot block usage, for diagnosable pool-pressure errors."""
        slots = ", ".join(
            f"s{i}=-" if r is None else
            f"s{i}=rid{r.rid}({len(r.blocks)} blk)"
            for i, r in enumerate(self.active))
        return (f"slot usage: {slots}; pending={len(self.pending)}; "
                f"pool free={self.allocator.n_free}/"
                f"{self.allocator.n_blocks - 1}")

    # -- admission / completion ----------------------------------------------
    def _admission_need(self, req: Request) -> Tuple[int, List[int]]:
        """(fresh blocks to allocate, already-shared block ids) for the
        head request: a swapped-out request needs its full saved context
        back; a fresh one needs prompt blocks (lazy) or the whole budget
        (reserve-up-front), minus any prefix-shared blocks."""
        if req.swap_blocks:
            return len(req.swap_blocks), []
        shared: List[int] = []
        if self.prefix is not None:
            shared = self.prefix.match(req.prompt)
        total = (req.prompt_blocks_needed(self.block_size) if self.lazy
                 else req.blocks_needed(self.block_size))
        return max(total - len(shared), 0), shared

    def admit(self, now: float) -> List[Tuple[int, Request]]:
        """Admit pending requests into free slots, FCFS, at most
        ``max_prefill_per_step`` per call.  Stops (leaving the head
        pending) when the pool cannot cover the head request's admission
        budget — FCFS back-pressure, no starvation via queue-jumping."""
        admitted: List[Tuple[int, Request]] = []
        slots = self.free_slots()
        while (self.pending and slots
               and len(admitted) < self.max_prefill_per_step):
            req = self.pending[0]
            need, shared = self._admission_need(req)
            if need > self.allocator.n_free:
                break
            self.pending.popleft()
            fresh = self.allocator.alloc(need)
            if shared:
                self.allocator.share(shared)
                self.shared_block_hits += len(shared)
            req.blocks = shared + fresh
            if self.prefix is not None and not req.swap_blocks:
                self.prefix.insert(
                    req.prompt,
                    req.blocks[:req.prompt_blocks_needed(self.block_size)])
            req.slot = slots.pop(0)
            req.admitted_at = req.admitted_at or now
            self.active[req.slot] = req
            admitted.append((req.slot, req))
        self.peak_active = max(self.peak_active, self.n_active)
        return admitted

    def _release(self, ids: List[int]) -> List[int]:
        freed = self.allocator.release(ids)
        if self.prefix is not None:
            for b in freed:
                self.prefix.drop_block(b)
        return freed

    def finish(self, slot: int, now: float) -> Request:
        req = self.active[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not active")
        req.finished_at = now
        self._release(req.blocks)
        req.blocks = []
        self.active[slot] = None
        return req

    # -- lazy growth, copy-on-write forks ------------------------------------
    def prepare_append(self, req: Request,
                       pos: int) -> Optional[Tuple[int, int]]:
        """Host bookkeeping before the compiled append writes position
        ``pos`` of ``req``'s context.  Grows the request's block list
        when ``pos`` crosses into an unowned block (lazy allocation;
        raises a diagnosable :class:`PagePoolExhausted` under pool
        pressure — the engine answers with preemption).  Returns a
        ``(src_block, dst_block)`` fork instruction when the target
        block is referenced by another page table (copy-on-write: the
        engine must run the compiled ``paged.copy`` before appending),
        else ``None``.  A private indexed block is dropped from the
        prefix index instead — its content is about to diverge from the
        prompt prefix the index describes."""
        bi = pos // self.block_size
        if bi >= self.max_blocks_per_slot:
            raise PagePoolExhausted(
                f"request {req.rid} position {pos} exceeds page table "
                f"width {self.max_blocks_per_slot}")
        if bi >= len(req.blocks):
            try:
                req.blocks.extend(self.allocator.alloc(1))
            except PagePoolExhausted as e:
                raise PagePoolExhausted(
                    f"{e}; {self.describe_usage()}") from None
            return None
        bid = req.blocks[bi]
        if self.allocator.refcount(bid) > 1:
            try:
                new = self.allocator.alloc(1)[0]
            except PagePoolExhausted as e:
                raise PagePoolExhausted(
                    f"{e}; {self.describe_usage()}") from None
            self._release([bid])
            req.blocks[bi] = new
            self.forks += 1
            return (bid, new)
        if self.prefix is not None and self.prefix.indexed(bid):
            self.prefix.drop_block(bid)
        return None

    # -- preemption / swap tier ----------------------------------------------
    def pick_victim(self) -> Optional[Request]:
        """Lowest-priority in-flight request (latest arrival, ties by
        rid) — the vLLM eviction order under pool pressure."""
        live = [r for r in self.active if r is not None]
        if not live:
            return None
        return max(live, key=lambda r: (r.arrival, r.rid))

    def preempt(self, slot: int, swap_blocks: List[int]) -> Request:
        """Detach the request in ``slot``, release its pool blocks, and
        requeue it at the head of the pending queue carrying
        ``swap_blocks`` (where the engine's compiled ``paged.swap_out``
        saved its KV).  The engine must run the swap-out copy *before*
        calling this — released blocks can be reallocated and
        overwritten immediately."""
        req = self.active[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not active")
        self._release(req.blocks)
        req.blocks = []
        req.slot = None
        req.swap_blocks = list(swap_blocks)
        self.active[slot] = None
        # FCFS re-admission: every pending request was submitted at or
        # after this one's admission, so the head is its arrival slot
        self.pending.appendleft(req)
        self.preemptions += 1
        return req

    def telemetry(self) -> dict:
        return {"preemptions": self.preemptions,
                "forks": self.forks,
                "shared_block_hits": self.shared_block_hits,
                "peak_active": self.peak_active,
                "lazy": self.lazy,
                "prefix_sharing": self.prefix is not None}

    def alias_invariant(self) -> dict:
        """The copy-on-write invariant as data, for crossing into IR:
        blocks currently mapped into more than one page table.  The
        serving loop threads ``shared_blocks`` into the static
        ``shared_block_ids`` attr of the compiled ``paged.append`` /
        ``paged.copy`` step, which is how the ``check_paged_alias``
        analysis (repro_torch.core.analysis) verifies statically what
        :meth:`prepare_append` guarantees dynamically — no write into a
        shared block without a fork."""
        return {"shared_blocks": self.allocator.shared_blocks()}


def poisson_arrivals(n: int, rate_per_s: float, rng) -> List[float]:
    """Arrival offsets (seconds) for ``n`` requests under a Poisson
    process of ``rate_per_s`` — exponential inter-arrival gaps."""
    gaps = rng.exponential(1.0 / max(rate_per_s, 1e-9), size=n)
    times = gaps.cumsum()
    return [float(t) for t in times]
