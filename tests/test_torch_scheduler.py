"""The serving scheduler — block allocator, prefix index, continuous
admission, preemption — is host-side bookkeeping that the port copies
(``repro_torch/runtime/scheduler.py``) rather than imports.  Every case
here runs on both packages' modules, so the copy is held to the
reference's behaviour case for case."""
import numpy as np
import pytest

from repro.runtime import scheduler as jsched
from repro_torch.runtime import scheduler as tsched

MODULES = {"reference": jsched, "port": tsched}


@pytest.fixture(params=sorted(MODULES))
def S(request):
    return MODULES[request.param]


def _req(S, rid, n, gen_len, arrival=0.0, prompt=None):
    return S.Request(rid=rid, prompt=np.zeros(n, np.int32)
                     if prompt is None else prompt,
                     gen_len=gen_len, arrival=arrival)


def test_scheduler_rejects_request_wider_than_page_table(S):
    sched = S.ContinuousScheduler(1, S.BlockAllocator(8), block_size=4,
                                  max_blocks_per_slot=2)
    with pytest.raises(S.PagePoolExhausted):
        sched.submit(_req(S, 0, 8, 8))          # 4 blocks > table width 2


def test_admission_backpressure_waits_for_freed_blocks(S):
    alloc = S.BlockAllocator(4)                 # 3 allocatable blocks
    sched = S.ContinuousScheduler(2, alloc, block_size=4,
                                  max_blocks_per_slot=2,
                                  max_prefill_per_step=2)
    a, b = (_req(S, i, 4, 4) for i in range(2))     # 2 blocks each
    sched.submit(a)
    sched.submit(b)
    assert [r.rid for _, r in sched.admit(0.0)] == [0]
    assert sched.admit(0.1) == []               # 1 free block < b's 2
    sched.finish(a.slot, 0.2)
    assert a.blocks == [] and a.finished_at == 0.2
    assert [r.rid for _, r in sched.admit(0.3)] == [1]
    assert alloc.n_free == 1


def test_block_allocator_free_list(S):
    with pytest.raises(ValueError):
        S.BlockAllocator(1)                     # block 0 alone is no pool
    alloc = S.BlockAllocator(4)
    assert alloc.n_free == 3
    got = alloc.alloc(3)
    assert sorted(got) == [1, 2, 3]             # block 0 never handed out
    with pytest.raises(S.PagePoolExhausted):
        alloc.alloc(1)
    alloc.release(got[:2])
    assert alloc.n_free == 2


def test_block_allocator_refcounts(S):
    alloc = S.BlockAllocator(5)
    a, b = alloc.alloc(2)
    alloc.share([a])
    assert alloc.refcount(a) == 2
    assert alloc.release([a]) == []             # still referenced
    assert alloc.release([a]) == [a]            # last reference frees
    with pytest.raises(ValueError):
        alloc.share([a])                        # can't share a free block
    with pytest.raises(ValueError):
        alloc.release([a])                      # double free
    tel = alloc.telemetry()
    assert tel["peak_blocks_in_use"] == 2
    assert tel["total_allocs"] == 2
    assert alloc.release([b]) == [b]


def test_prefix_index_chain_matching(S):
    idx = S.PrefixIndex(4)
    p1 = np.asarray([1, 2, 3, 4, 5, 6], np.int32)
    idx.insert(p1, [7, 8])
    assert idx.match(p1) == [7, 8]              # full + exact partial tail
    assert idx.match(np.asarray([1, 2, 3, 4, 9], np.int32)) == [7]
    assert idx.match(np.asarray([1, 9, 3, 4, 5, 6], np.int32)) == []
    idx.drop_block(8)
    assert idx.match(p1) == [7]                 # partial entry forgotten


def test_prepare_append_grows_forks_and_drops(S):
    alloc = S.BlockAllocator(8)
    idx = S.PrefixIndex(4)
    sched = S.ContinuousScheduler(2, alloc, 4, 4, max_prefill_per_step=2,
                                  lazy=True, prefix_index=idx)
    prompt = np.asarray([1, 2, 3, 4, 5, 6], np.int32)
    a = _req(S, 0, 0, 6, prompt=prompt)
    b = _req(S, 1, 0, 6, arrival=0.1, prompt=prompt.copy())
    sched.submit(a)
    sched.submit(b)
    sched.admit(0.0)
    assert b.blocks == a.blocks                 # fully shared prompt
    assert alloc.refcount(a.blocks[1]) == 2
    fork = sched.prepare_append(a, 6)           # shared partial tail: CoW
    assert fork is not None
    src, dst = fork
    assert src == b.blocks[1] and a.blocks[1] == dst
    assert alloc.refcount(src) == 1
    assert sched.telemetry()["forks"] == 1
    assert sched.prepare_append(b, 6) is None   # private now: entry dropped
    assert not idx.indexed(b.blocks[1])
    n0 = len(a.blocks)
    assert sched.prepare_append(a, 8) is None   # lazy growth
    assert len(a.blocks) == n0 + 1


def test_preempt_requeues_head_and_resumes_fcfs(S):
    alloc = S.BlockAllocator(6)
    sched = S.ContinuousScheduler(2, alloc, 4, 4, max_prefill_per_step=2,
                                  lazy=True)
    a, b, c = (_req(S, i, 4, 8, arrival=i / 10) for i in range(3))
    for r in (a, b, c):
        sched.submit(r)
    sched.admit(0.0)
    assert sched.pick_victim() is b             # latest arrival in flight
    vblocks = list(b.blocks)
    sched.preempt(b.slot, [5])
    assert b.swap_blocks == [5] and b.blocks == [] and b.slot is None
    assert sched.pending[0] is b                # ahead of c: FCFS resume
    assert alloc.refcount(vblocks[0]) == 0
    admitted = sched.admit(0.3)
    assert admitted and admitted[0][1] is b
    assert len(b.blocks) == 1
    assert sched.telemetry()["preemptions"] == 1


def test_pool_exhaustion_message_is_diagnosable(S):
    alloc = S.BlockAllocator(4)
    alloc.alloc(3)
    with pytest.raises(S.PagePoolExhausted) as ei:
        alloc.alloc(2)
    msg = str(ei.value)
    assert "need 2" in msg and "free" in msg and "pool of 4" in msg
    sched = S.ContinuousScheduler(1, S.BlockAllocator(4), 4, 8, lazy=True)
    req = _req(S, 0, 4, 8)
    sched.submit(req)
    sched.admit(0.0)
    sched.allocator.alloc(2)                    # external pool pressure
    with pytest.raises(S.PagePoolExhausted) as ei:
        sched.prepare_append(req, 4)
    assert "slot usage" in str(ei.value)


def test_poisson_arrivals_agree(rng):
    a = jsched.poisson_arrivals(20, 5.0, np.random.default_rng(3))
    b = tsched.poisson_arrivals(20, 5.0, np.random.default_rng(3))
    assert a == b and a == sorted(a)
