"""Serving entry point: continuous batching over a block-paged KV cache —
the port of the reference's ``launch/serve.py``.

The engine (:func:`serve_paged`):

* a request queue with **continuous (in-flight) batching** — finished
  decode slots are refilled every step, ragged prompt lengths allowed;
* a **block-paged KV cache**: per-slot page tables over a shared pool of
  fixed-size blocks, freed on request completion.  The page gather /
  append / copy steps are ``paged.*`` ops compiled through the pipeline
  (``paged_to_kokkos``), never host Python;
* **prefill/decode disaggregation** — admission is bounded by
  ``--max-prefill-per-step`` so bursts cannot stall the decode loop;
* **lazy block allocation** (``--lazy-alloc``) with preemption to a swap
  arena (compiled ``paged.swap_out`` / ``paged.swap_in``) under pool
  pressure;
* **chunked prefill** (``--prefill-chunk N``), interleaved with decode;
* **copy-on-write prefix sharing** (``--prefix-share``), the fork a
  compiled ``paged.copy``.

What differs from the reference: PyTorch runs eagerly, so there is no
jitted program to cache; ``ENGINE_CACHE_STATS`` counts the compiled
one-op programs of the ``paged.*`` ops instead (``core.ops``).  The
reference's jitted decode step donates the pools; here each step's
per-layer pools replace the old ones (``models/serve.py``).  Sampling
draws from a ``torch.Generator`` seeded by ``--seed``, so non-greedy
samples differ from JAX's; greedy decoding is what matches the
reference.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --paged --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.core import ops as cops
from repro_torch.core.options import CompileOptions, use_options
from repro_torch.launch.steps import cast_compute
from repro_torch.models import serve as serve_mod
from repro_torch.models.model import build_model
from repro_torch.runtime.scheduler import (BlockAllocator, ContinuousScheduler,
                                           PagePoolExhausted, PrefixIndex,
                                           Request, poisson_arrivals)

# the compiled one-op programs of the paged ops (hits, misses, evictions)
ENGINE_CACHE_STATS = cops.PIPELINE_CACHE_STATS


def _device_of(params) -> torch.device:
    return params["embed"]["table"].device


def _sample(logits: torch.Tensor, vocab: int, greedy: bool,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax, or a draw from the softmax with ``gen``."""
    logits = logits[..., :vocab]
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float(), dim=-1)
    flat = probs.reshape(-1, vocab)
    draw = torch.multinomial(flat, 1, generator=gen)[:, 0]
    return draw.reshape(probs.shape[:-1]).to(torch.int32)


def generate(model, params, prompts: np.ndarray, *, gen_len: int,
             max_len: int, quantized: bool = False, greedy: bool = True,
             rng: Optional[np.random.Generator] = None,
             gen: Optional[torch.Generator] = None) -> np.ndarray:
    """Prefill + decode ``gen_len`` tokens for a batch of equal-length
    prompts on the contiguous cache.  Returns (B, gen_len) generated ids.
    An audio model (whisper) takes (B, encoder_seq, d_model) standard
    normal frames drawn from ``rng`` (``default_rng(0)`` if none), as
    the reference's frontend stub does.  Non-greedy decode draws from
    ``gen`` (one generator per serving seed, never one rebuilt per
    position)."""
    B, S = prompts.shape
    dev = _device_of(params)
    cfg = model.cfg
    if not greedy and gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int32,
                                       device=dev)}
    if cfg.frontend == "audio":
        rng = rng or np.random.default_rng(0)
        batch["audio_frames"] = torch.as_tensor(
            rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)),
            dtype=torch.float32, device=dev)
    logits, cache = model.prefill(params, batch, max_len=max_len,
                                  quantized=quantized)
    out = []
    length = S
    for _ in range(gen_len):
        tok = _sample(logits, cfg.vocab_size, greedy, gen)
        out.append(tok.cpu().numpy())
        logits, cache = model.decode_step(params, tok, cache, length)
        length += 1
    return np.stack(out, axis=1)


def serve_loop(model, params, *, n_requests: int, batch: int,
               prompt_len: int, gen_len: int, quantized: bool = False,
               greedy: bool = True, seed: int = 0) -> dict:
    """Fixed waves of ``batch`` requests over the contiguous cache; the
    serving ``seed`` seeds the prompts (and, after them, an audio
    model's frames, wave by wave) and the one sampling generator."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=_device_of(params))
    gen.manual_seed(seed)
    queue: List[np.ndarray] = [rng.integers(1, cfg.vocab_size, prompt_len)
                               for _ in range(n_requests)]
    done = tokens_out = 0
    t0 = time.monotonic()
    while queue:
        wave, queue = queue[:batch], queue[batch:]
        prompts = np.stack(wave + [wave[-1]] * (batch - len(wave)))
        generate(model, params, prompts, gen_len=gen_len,
                 max_len=prompt_len + gen_len, quantized=quantized,
                 greedy=greedy, rng=rng, gen=gen)
        done += len(wave)
        tokens_out += gen_len * len(wave)
    dt = time.monotonic() - t0
    return {"requests": done, "tokens": tokens_out, "seconds": dt,
            "tok_per_s": tokens_out / max(dt, 1e-9)}


# ---------------------------------------------------------------------------
# the serving engine: continuous batching over the block-paged KV cache
# ---------------------------------------------------------------------------

def make_requests(n: int, *, prompt_len: int, gen_len: int, vocab: int,
                  seed: int = 0, ragged: bool = False,
                  arrival_rate: Optional[float] = None) -> List[Request]:
    """Synthetic request set.  ``ragged`` draws per-request prompt and
    generation lengths from [1, prompt_len] / [1, gen_len]; a Poisson
    ``arrival_rate`` (requests/s) staggers arrivals, else all arrive at
    t=0."""
    rng = np.random.default_rng(seed)
    arrivals = (poisson_arrivals(n, arrival_rate, rng)
                if arrival_rate else [0.0] * n)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(1, prompt_len + 1)) if ragged else prompt_len
        glen = int(rng.integers(1, gen_len + 1)) if ragged else gen_len
        prompt = rng.integers(1, vocab, plen).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, gen_len=glen,
                            arrival=arrivals[i]))
    return reqs


def serve_paged(model, params, requests: Sequence[Request], *,
                n_slots: int, block_size: int, num_blocks: int,
                max_prefill_per_step: int = 1, quantized: bool = False,
                greedy: bool = True, seed: int = 0,
                policy: str = "continuous",
                lazy_alloc: bool = False, prefill_chunk: int = 0,
                prefix_share: bool = False, num_swap_blocks: int = 0,
                options: Optional[CompileOptions] = None) -> dict:
    """Serve ``requests`` with continuous batching over the paged cache.

    ``policy="continuous"`` refills freed slots every decode step;
    ``policy="static"`` admits a wave only when every slot is free (and
    enough requests have arrived to fill it, or none remain) and runs it
    to completion over the same kernels.  ``lazy_alloc`` admits on
    prompt-block availability, grows page tables block by block and
    preempts to a swap arena (``num_swap_blocks``, default
    ``num_blocks``) under pool pressure.  ``prefill_chunk`` (a multiple
    of ``block_size``) prefills long prompts that many tokens per engine
    iteration.  ``prefix_share`` maps shared prompt-prefix blocks into
    several page tables, copy-on-write.  ``options`` pick the target and
    the device (``params`` must live there).

    Returns a dict with the finished Request objects (tokens + per-token
    emission timestamps), decode step count, wall time and a
    ``telemetry`` block, keyed as the reference's.  Mutates the
    ``requests`` objects in place.
    """
    cfg = model.cfg
    if policy not in ("continuous", "static"):
        raise ValueError(policy)
    if prefill_chunk and prefill_chunk % block_size:
        raise ValueError(
            f"prefill_chunk ({prefill_chunk}) must be a multiple of "
            f"block_size ({block_size}): non-final chunks must fill "
            f"whole KV blocks")
    options = options or CompileOptions()
    dev = torch.device(options.resolve_device())
    if _device_of(params).type != dev.type:
        raise ValueError(f"params on {_device_of(params)}, engine on {dev}")
    requests = sorted(requests, key=lambda r: r.arrival)
    max_ctx = max(r.prompt_len + r.gen_len for r in requests)
    max_blocks = -(-max_ctx // block_size)
    sched = ContinuousScheduler(
        n_slots, BlockAllocator(num_blocks), block_size, max_blocks,
        max_prefill_per_step=(n_slots if policy == "static"
                              else max_prefill_per_step),
        lazy=lazy_alloc,
        prefix_index=PrefixIndex(block_size) if prefix_share else None)

    def ids(seq) -> torch.Tensor:
        return torch.as_tensor(np.asarray(seq, np.int32), device=dev)

    with use_options(options):
        pools = model.init_paged_cache(num_blocks, block_size,
                                       quantized=quantized, device=dev)
        swap_pools = swap_alloc = None
        if lazy_alloc:
            # the preemption tier: an arena of the same block geometry
            # (block 0 reserved, like the pool)
            n_swap = num_swap_blocks or num_blocks
            swap_pools = model.init_paged_cache(n_swap + 1, block_size,
                                                quantized=quantized,
                                                device=dev)
            swap_alloc = BlockAllocator(n_swap + 1)
        table = np.zeros((n_slots, max_blocks), np.int32)
        lengths = np.zeros((n_slots,), np.int32)
        next_tok = np.zeros((n_slots,), np.int32)
        prefilling: dict = {}    # slot -> Request mid-chunked-prefill
        chunk_rr = 0             # round-robin cursor over prefilling

        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def sample(logits):
            return _sample(logits, cfg.vocab_size, greedy, gen)

        t0 = time.monotonic()

        def clock() -> float:
            return time.monotonic() - t0

        idx = 0            # next not-yet-arrived request
        steps = 0

        def scan_arrivals():
            nonlocal idx
            now = clock()
            while idx < len(requests) and requests[idx].arrival <= now:
                sched.submit(requests[idx])
                idx += 1

        def retire(slot: int, req: Request, now: float):
            sched.finish(slot, now)
            table[slot, :] = 0       # back to the scrap block
            lengths[slot] = 0
            next_tok[slot] = 0

        def swap_out(victim: Request):
            """Evict ``victim`` to the swap arena.  The compiled
            ``paged.swap_out`` copy runs BEFORE the scheduler releases
            the pool blocks — a freed block can be reallocated and
            overwritten by the very next admission."""
            try:
                sids = swap_alloc.alloc(len(victim.blocks))
            except PagePoolExhausted as e:
                raise PagePoolExhausted(
                    f"swap arena exhausted while preempting request "
                    f"{victim.rid}: {e}; {sched.describe_usage()}"
                ) from None
            src, dst = ids(victim.blocks), ids(sids)
            for k in swap_pools:
                swap_pools[k] = [
                    cops.page_swap_out(s, p, src, dst, block_size=block_size)
                    for s, p in zip(swap_pools[k], pools[k])]
            prefilling.pop(victim.slot, None)
            sched.preempt(victim.slot, sids)

        def swap_in(req: Request):
            """Re-admission of a preempted request: restore its saved
            blocks into the freshly allocated ``req.blocks``."""
            src, dst = ids(req.swap_blocks), ids(req.blocks)
            for k in pools:
                pools[k] = [
                    cops.page_swap_in(p, s, src, dst, block_size=block_size)
                    for p, s in zip(pools[k], swap_pools[k])]
            swap_alloc.release(req.swap_blocks)
            req.swap_blocks = []

        def ensure_append_capacity():
            """Before a decode step, make sure every decoding slot owns
            the block its KV append will write: lazily grow across block
            boundaries, fork refcount-shared (CoW) blocks, and — under
            pool pressure — preempt the lowest-priority request to the
            swap tier and retry."""
            for slot in range(n_slots):
                req = sched.active[slot]
                if req is None or slot in prefilling:
                    continue
                while True:
                    try:
                        fork = sched.prepare_append(
                            req, req.stored_positions())
                    except PagePoolExhausted:
                        if swap_alloc is None:
                            raise
                        victim = sched.pick_victim()
                        if victim is None:
                            raise
                        swap_out(victim)
                        if victim is req:
                            break    # the requester itself was evicted
                        continue
                    if fork is not None:
                        s, d = ids(fork[:1]), ids(fork[1:])
                        for k in pools:
                            pools[k] = [cops.page_copy(
                                p, p, s, d, block_size=block_size)
                                for p in pools[k]]
                    break

        def sync_slots():
            """Rebuild the page table / lengths / next token from
            scheduler state (the single source of truth)."""
            for slot in range(n_slots):
                req = sched.active[slot]
                table[slot, :] = 0
                if req is None or slot in prefilling or not req.tokens:
                    lengths[slot] = 0
                    next_tok[slot] = 0
                    continue
                table[slot, :len(req.blocks)] = req.blocks
                lengths[slot] = req.stored_positions()
                next_tok[slot] = req.tokens[-1]

        def advance_chunk():
            """Run one prefill chunk for one mid-prefill slot
            (round-robin); mid-prefill slots keep a scrap page-table row
            in the decode step, so a shared prompt block is never
            clobbered by their idle decode appends."""
            nonlocal pools, chunk_rr
            slots = sorted(prefilling)
            slot = slots[chunk_rr % len(slots)]
            chunk_rr += 1
            req = prefilling[slot]
            start = req.prefill_pos
            size = min(prefill_chunk, req.prompt_len - start)
            row = np.zeros((max_blocks,), np.int32)
            row[:len(req.blocks)] = req.blocks
            logits, pools = model.paged_prefill_chunk(
                params, ids(req.prompt[start:start + size]), start, pools,
                ids(row), block_size=block_size)
            req.prefill_pos += size
            if req.prefill_pos < req.prompt_len:
                return
            del prefilling[slot]     # prompt fully cached: start decode
            req.tokens.append(int(sample(logits)))
            req.token_times.append(clock())
            if req.done:             # gen_len == 1: prefill was enough
                retire(slot, req, clock())

        while sched.has_work() or idx < len(requests):
            scan_arrivals()
            if policy == "static" and (
                    sched.n_active > 0
                    or (len(sched.pending) < n_slots
                        and idx < len(requests))):
                admitted = []        # wave barrier: wait to fill / drain
            else:
                admitted = sched.admit(clock())
            for slot, req in admitted:
                if req.swap_blocks:  # resumed from the swap tier
                    swap_in(req)
                    if not req.tokens:
                        prefilling[slot] = req   # preempted mid-prefill
                    continue
                if prefill_chunk and req.prompt_len > prefill_chunk:
                    prefilling[slot] = req       # chunked: interleaved
                    continue
                logits, cache = model.prefill(
                    params, {"tokens": ids(req.prompt[None])},
                    max_len=req.prompt_len, quantized=quantized)
                pools = serve_mod.scatter_prefill_paged(
                    pools, cache["kv"], req.blocks, block_size)
                req.tokens.append(int(sample(logits[0])))
                req.token_times.append(clock())
                req.prefill_pos = req.prompt_len
                if req.done:         # gen_len == 1: prefill was enough
                    retire(slot, req, clock())
            if prefilling:
                # chunked prefill: one chunk per engine iteration,
                # interleaved with the decode step below
                advance_chunk()
            decodable = sum(
                1 for s in range(n_slots)
                if sched.active[s] is not None and s not in prefilling)
            if decodable == 0:
                if sched.n_active == 0 and not prefilling \
                        and idx < len(requests):
                    # idle until the next arrival
                    time.sleep(max(requests[idx].arrival - clock(), 0.0))
                continue
            ensure_append_capacity()
            sync_slots()
            # the step is enqueued on the device; the host scans arrivals
            # while it runs and waits only for the token readback
            logits, pools = model.paged_decode_step(
                params, ids(next_tok), pools, ids(table), ids(lengths),
                block_size=block_size)
            tok_dev = sample(logits)
            steps += 1
            scan_arrivals()
            tok_host = tok_dev.cpu().numpy()
            t_emit = clock()
            for slot in range(n_slots):
                req = sched.active[slot]
                if req is None or slot in prefilling:
                    continue         # inactive slots appended to scrap
                req.tokens.append(int(tok_host[slot]))
                req.token_times.append(t_emit)
                if req.done:
                    retire(slot, req, t_emit)

    total_tokens = sum(len(r.tokens) for r in requests)
    telemetry = sched.telemetry()
    telemetry["allocator"] = sched.allocator.telemetry()
    if swap_alloc is not None:
        telemetry["swap"] = swap_alloc.telemetry()
    telemetry["engine_cache"] = dict(ENGINE_CACHE_STATS)
    return {"requests": list(requests), "steps": steps,
            "tokens": total_tokens, "seconds": clock(),
            "tok_per_s": total_tokens / max(clock(), 1e-9),
            "telemetry": telemetry}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="qwen2-1.5b",
                   help="one of the ten architecture ids: "
                        + ", ".join(all_arch_ids()))
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--batch", "--slots", dest="batch", type=int, default=4,
                   help="decode slots (batch rows) served in lock-step")
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen-len", type=int, default=16)
    p.add_argument("--quantized-kv", action="store_true",
                   help="int8 KV cache (+ per-block scale pools when "
                        "--paged)")
    p.add_argument("--sample", action="store_true",
                   help="sample instead of greedy argmax decode")
    p.add_argument("--seed", type=int, default=0,
                   help="root seed for prompts and sampling")
    p.add_argument("--paged", action="store_true",
                   help="serve with the continuous-batching engine over "
                        "the block-paged KV cache")
    p.add_argument("--policy", default="continuous",
                   choices=("continuous", "static"),
                   help="slot refill policy for --paged")
    p.add_argument("--block-size", type=int, default=16,
                   help="KV block size (positions per page) for --paged")
    p.add_argument("--num-blocks", type=int, default=0,
                   help="shared pool size for --paged (0 = sized to fit "
                        "all slots + one spare request)")
    p.add_argument("--max-prefill-per-step", type=int, default=1,
                   help="admissions between decode steps")
    p.add_argument("--lazy-alloc", action="store_true",
                   help="admit on prompt-block availability, grow page "
                        "tables during generation, preempt to a swap "
                        "arena under pool pressure")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked prefill size in tokens (multiple of "
                        "--block-size; 0 = monolithic prefill)")
    p.add_argument("--prefix-share", action="store_true",
                   help="copy-on-write sharing of common prompt-prefix "
                        "blocks across requests")
    p.add_argument("--num-swap-blocks", type=int, default=0,
                   help="swap arena size for --lazy-alloc preemption "
                        "(0 = same as --num-blocks)")
    p.add_argument("--ragged", action="store_true",
                   help="draw ragged prompt/gen lengths per request")
    p.add_argument("--arrival-rate", type=float, default=None,
                   help="Poisson arrival rate (requests/s); default: all "
                        "requests arrive at t=0")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the weights, caches and kernels run")
    p.add_argument("--target", default="cuda",
                   help="compile target (backend) of the kernels and the "
                        "paged ops: cuda, torch, auto or loops")
    args = p.parse_args(argv)
    options = CompileOptions(target=args.target, device=args.device)
    device = options.resolve_device()
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)
    params = model.init(0, device, dtype=cfg.compute_dtype)
    if args.paged:
        reqs = make_requests(args.requests, prompt_len=args.prompt_len,
                             gen_len=args.gen_len, vocab=cfg.vocab_size,
                             seed=args.seed, ragged=args.ragged,
                             arrival_rate=args.arrival_rate)
        blocks_per_req = -(-(args.prompt_len + args.gen_len)
                           // args.block_size)
        num_blocks = args.num_blocks or \
            1 + blocks_per_req * (args.batch + 1)
        out = serve_paged(model, params, reqs, n_slots=args.batch,
                          block_size=args.block_size,
                          num_blocks=num_blocks,
                          max_prefill_per_step=args.max_prefill_per_step,
                          quantized=args.quantized_kv,
                          greedy=not args.sample, seed=args.seed,
                          policy=args.policy,
                          lazy_alloc=args.lazy_alloc,
                          prefill_chunk=args.prefill_chunk,
                          prefix_share=args.prefix_share,
                          num_swap_blocks=args.num_swap_blocks,
                          options=options)
        print(f"[serve:{args.policy}] {len(out['requests'])} requests, "
              f"{out['tokens']} tokens in {out['steps']} decode steps, "
              f"{out['tok_per_s']:.1f} tok/s")
        return 0
    with use_options(options):
        out = serve_loop(model, params, n_requests=args.requests,
                         batch=args.batch, prompt_len=args.prompt_len,
                         gen_len=args.gen_len, quantized=args.quantized_kv,
                         greedy=not args.sample, seed=args.seed)
    print(f"[serve] {out['requests']} requests, {out['tokens']} tokens, "
          f"{out['tok_per_s']:.1f} tok/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
