#!/usr/bin/env python3
"""Smoke run of the torch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. print the card (``nvidia-smi``) and build every hand kernel of the
   main paths from ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a),
   all builds started together; fail unless the bf16 flash library's
   SASS (``cuobjdump -sass``) holds HGMMA (wgmma) and UTMALDG (TMA), the
   decode-attention library's bf16 kernels HMMA (``mma.sync``) and both
   its kernels LDGSTS (``cp.async``), every small batched-product
   library's kernels LDGSTS, and, in both GEMM libraries (``matmul.cu``
   and the tiled ``batched_gemm.cu``), every bf16 ``wgmma`` kernel HGMMA
   and UTMALDG and every f32 FFMA kernel LDGSTS, and every register-path
   kernel of RMSNorm and the row softmax (``rmsnorm.cu``,
   ``row_softmax.cu``: f32 and bf16, 1-8 vectors a thread) 16-byte loads
   (LDG.E.128) and no local memory (LDL / STL), every grouped
   expert-product kernel (``grouped_gemm.cu``) HGMMA and UTMALDG and no
   local memory, every RG-LRU kernel
   (``rglru.cu``) no local memory, its vector kernels 16-byte cp.async into
   their shared ring (LDGSTS.E.BYPASS.128),
   every SpMV kernel (``spmv.cu``) its evict-first stream loads
   (LDG.E.EF..., 16 bytes on the vector path), every SpMM kernel
   (``spmm.cu``) evict-first stream loads and no local memory, its vector
   kernels 16-byte B gathers (LDG.E.128), every f32 flash kernel
   (``flash_attention.cu``, D = 16 ... 256) LDGSTS (``cp.async``), every
   WKV kernel (``rwkv6.cu``) HMMA (``mma.sync``, 3xTF32), and every f32
   flash and WKV kernel no local memory;
2. fail unless every generated region library (``codegen.py`` around
   ``block_map.cuh``: one flat map kernel each) loads by 16 bytes
   (LDG.E.128) and touches no local memory; hold each kernel against its
   plain torch version on the card at the
   shapes the paths give it (mlp demo, ragged, gemv, the qwen2-1.5b MLP
   block at its published widths, each nest's launch plan printed and its
   C plan held to its Python twin; SpMV and SpMM on the sparse test
   matrices, one with trailing empty rows, against the plain versions
   evaluated in f64; the paged gather on the demo
   shapes; ResNet18's (8, 1000) softmax), with stated tolerances — the
   gather exactly; the row softmax timed at the mlp demo's (8, 10) and
   ResNet18's (8, 1000) beside ``torch.softmax``, its launch plan (the
   C plan held to its Python twin) printed;
3. run ``repro_torch.core.pipeline.main(["--demo", d, "--target",
   "cuda"])`` for mlp (sum 8.0, 4 launches), spmv (spmv + the relu
   nest), paged (the gather) and paged_swap (no hand kernel: the copies
   are library scatters), with no plain-version call, each against the
   same demo compiled for ``target="torch"``;
4. compile and run the qwen2-1.5b gated MLP block (d_model 1536, d_ff
   8960, silu, plus the residual) at T = 2048 tokens in f32 through
   ``pipeline.compile(..., target="cuda")``: 5 launches, no plain-version
   call, agreement with the plain block, and its time beside the same
   module compiled for the library (``target="torch"``); then the same
   block in bf16 (3 gemms on the ``wgmma`` route, 2 nests); each gemm's
   route and launch plan printed, and the three gemms timed in f32 and in
   bf16 beside ``torch.matmul``; the two nests timed in f32 and in bf16
   (the bf16 ones held within 2^-8 of their row's largest value) beside
   their plain versions and, for the residual add, ``torch.add``;
5. SpMV at the paper's Table 6.1 sizes: synthetic CSR matrices with the
   published rows, mean and max nonzeros per row of StocF-1465,
   PFlow_742, Elasticity3D and audikw_1 (Poisson row lengths, uniform
   columns, as ``benchmarks/spmv_bench.py`` builds them, at full rows),
   each compiled with ``ops.spmv_csr`` for ``target="cuda"``, held to the
   plain CSR version and timed beside cuSPARSE
   (``torch.sparse_csr_tensor @ x``) and the x gather alone
   (``x.index_select(0, cols)``, the practical ceiling), its launch plan
   printed (the C plan held to its Python twin); then SpMM of PFlow_742
   by 16 dense columns beside ``torch.sparse.mm`` and
   ``F.embedding_bag`` (the same CSR product in one call), its launch
   plan printed (the C plan held to its Python twin), two calls bitwise
   equal;
6. the paged decode step at qwen2-1.5b's KV widths (2 KV heads, head dim
   128, block 16, f32), 64 slots × 4096 positions: ``page_append`` →
   ``page_gather`` compiled for ``target="cuda"``, exactly equal to the
   ``torch`` target, the gather timed beside ``index_select`` + permute;
7. the serving kernels against their plain versions on the card, in f32
   and bf16: RMSNorm at the decode steps' (8, 1536), (4, 2560), (4, 4096)
   and the prefill's (2048, 1536), each timed in bf16 with its launch plan
   (held to the Python twin) and its mean |error| against an f64
   evaluation no larger than the plain version's; decode attention at
   8 slots x 12 query / 2 KV heads x 128 over 2048 positions with ragged
   lengths that include 0, 1 and 2048, a window case, a stride-0
   batch (the chunked prefill's broadcast row) and grok-1's logit cap
   (30 and 0.5, at 48 / 8 heads x 128 over 1152 positions, 2 rows split
   and 264 not, the queries times 10); flash attention at
   12 / 2 heads x 128 over 2048 causal positions and the sweep cases of
   ``tests/test_kernels.py`` (window, softcap, Sq != Skv, ragged tails),
   bf16 on the wgmma kernel and f32 on the FFMA one; each timed in bf16
   beside its bound, its plain version and one library call
   (``F.rms_norm``, ``F.scaled_dot_product_attention``), and the FFMA
   flash kernel in f32 at the same shape and at recurrentgemma-9b's 4 x
   16 / 1 heads x 2040 x 256 (window 2048) beside SDPA in f32, with its
   launch plan (the C plan held to its Python twin) and the card's
   blocks an SM; the bf16
   decode kernel's mean |error| against an f64 evaluation at most twice
   the plain version's (it rounds P to bf16 before P.V);
8. serving qwen2-1.5b at its published widths (28 layers, seeded bf16
   weights): ``repro_torch.launch.serve.main`` with ``--paged --target
   cuda`` over 16 ragged requests (prompts up to 512, up to 32 new
   tokens, 8 slots), once with monolithic prefill and once with
   ``--prefill-chunk 128``, each through flash attention, RMSNorm, the
   page gather and decode attention with no plain-version call; then
   prefill ms per prompt, the decode step's device and host time, its
   launches per kernel and RMSNorm's device ms per step (profiler), one
   decode step's bf16 logits on both
   targets against the same step at f32 (the kernels no less accurate
   than the plain versions), and the greedy tokens of every request
   against the ``torch`` target at f32 compute, exactly;
9. the recurrent families' kernels against their plain versions on the
   card, in f32 and bf16: the RWKV6 WKV scan at rwkv6-3b's prefill (4 x
   512 tokens, 40 heads x 64) and the RG-LRU scan at recurrentgemma-9b's
   (4 x 2040 tokens, 4096 channels) and decode step (T = 1), each from
   zero and from a given state, the final state included, and at the
   sweep shapes of ``tests/test_kernels.py``; flash attention at
   recurrentgemma's 16 / 1 heads x 256 with window 2048 and decode
   attention over its 2048-slot ring (with the same f64 error gate as
   phase 7); each timed in bf16 beside its bound, its plain version and,
   for attention, SDPA (no one torch call computes a scan), the RG-LRU
   scan also at the decode step (4 x 1 x 4096 from a given state), the
   WKV scan also in f32 and at extreme decays (w in [0, 1e-6], w = 0,
   w = 1, from a given state), each with its launch plan (the C plan
   held to its Python twin);
10. serving rwkv6-3b at its published widths (32 layers, seeded bf16
    weights): ``repro_torch.launch.serve.main`` (the wave loop) over 8
    requests in waves of 4, 512-token prompts, 32 new tokens, through
    the WKV scan and RMSNorm with no plain-version call; prefill ms,
    the decode step's host and device time, its launches per kernel and
    RMSNorm's device ms per step, the WKV scan's device ms per wave
    prefill (profiler), and every request's greedy tokens at f32 compute
    on the ``cuda`` target against ``torch``, exactly;
11. the same for recurrentgemma-9b (38 layers, 9.4 B parameters) over 4
    requests of 2040 + 32 tokens, so decode crosses the ring's wrap at
    2048, through the RG-LRU scan, flash attention (head dim 256,
    window), decode attention (16 query heads per KV head) and RMSNorm,
    with the wave prefill's device time and largest kernels, and the
    RG-LRU scan's device ms per prefill and per decode step, from the
    profiler; each model is freed before the next;
12. batched products through ``pipeline.compile(lambda a, b:
    ops.matmul(a, b), target="cuda")`` in f32 and bf16 at paper Fig
    6.3's four cases (256 x 16^3, 256 x 32^3, 64 x 64^3, 16 x 128^3), at
    16384 x 32^3, at the per-head QK^T of one 2048-token qwen2-1.5b
    sequence (12 x 2048 x 128 x 2048) and at qwen2-1.5b's up-projection
    on a 3-D activation ((8, 256, 1536) x (1536, 8960), B broadcast):
    each through one launch of the small or the tiled kernel (bf16 on the
    ``wgmma`` route, f32 on FFMA; the route and plan printed) with no
    plain call, held to the plain version (f32 2e-4, bf16 2e-2) and
    timed beside its bound, the plain version and ``torch.matmul``; then
    one eager ``ops.matmul`` on card tensors and a 4-D batch;
13. ResNet18 at full width (1000 classes) on 8 x 3 x 224 x 224 through
    ``pipeline.compile`` for ``cuda`` and ``torch`` (cuDNN convolutions
    with TF32 off on both): the gemm, nest and softmax kernels launched
    and no plain call, the probabilities equal to rtol 1e-3 / atol 1e-6
    with the same top-1 classes and rows summing to 1, each target within
    1e-3 of an f64 evaluation, both calls timed (and the 17 nests'
    device ms per call from the profiler), the §4.3 DualView
    ablation (host weights: h2d + d2h of one call, lazy against eager),
    and the fc gemm (8 x 512 x 1000, f32, split-K) alone beside
    ``torch.matmul``, its plan printed and two calls bitwise equal;
14. the MALA LDOS surrogate (91 -> 400 x 3 -> 201) on 8748 points, cuda
    against torch to 1e-4 of the output's scale, one gemm launch per
    layer, both timed;
16. (run before 15's lines) training through ``launch/train.py`` and
    ``launch/steps.py``: first the bf16 and f32 flash kernels and
    RMSNorm against their plain versions at the shapes this phase's
    forward gives them (8 and 4 x 12/2 heads x 512 x 128 causal, strided
    views; 8 and 4 x 512 x 1536 rows), phase 7's tolerances; then the
    fused AdamW update (``kernels/adamw.py``) over qwen2-1.5b's leaves at
    full size (1.544 B entries: bf16 gradients, f32 master and moments)
    against the plain branch leaf by leaf, without clipping bit for bit
    and with clipping within 1e-6 of each leaf's largest entry (the
    gradient norm within 1e-6 relative, lr equal), 2 x leaves + 1
    launches and no plain call; its device ms printed beside its bytes
    bound (28 B an entry at this phase's measured HBM stream rate,
    ``machine_peaks.measure_bandwidth``) and the plain branch's ms; (a)
    qwen2-1.5b at its published widths (28
    layers, tied 151936 vocab, seeded weights), bf16 compute over an f32
    master with AdamW, ``train_loop`` for 6 steps of 8 x 512 tokens on
    the ``cuda`` target: every loss finite and the last below the first,
    exactly 28 bf16 flash and 57 RMSNorm launches a step (2 a layer and
    the final norm), 2 x leaves + 1 fused AdamW launches a step, and no
    plain call; each step's wall ms, tokens/s and
    model FLOPs (6 N T plus attention) over the bf16 peak, then the same
    6 steps under the profiler for each step's device busy ms and peak
    memory; (b) one step with ``remat_policy="nothing"`` against one
    without from the same state: loss and gradient norm within 1e-3
    relative, 56 flash and 113 RMSNorm launches (each layer's forward
    runs again in the backward); the same step on ``torch`` (the plain
    versions): loss within 1e-3 relative, gradient norm within 1e-2, and
    the forward's logits within 3e-2 of the largest; (c) the same model
    at f32 compute, batch 4 x 512: the forward's logits on ``cuda`` (the
    FFMA flash kernel, RMSNorm) and ``torch`` within 1e-5 of the
    largest, then 3 steps from one carried state on each: every loss
    within 1e-6 relative, every gradient norm within 1e-5, side by side;
    (d) rwkv6-3b and recurrentgemma-9b reduced, 3 steps of 4 x 64
    at f32 compute, ``cuda`` against ``torch`` within 1e-4 relative
    through the WKV / RG-LRU scans, flash attention and RMSNorm with no
    plain call; (e) qwen2-1.5b reduced, 12 steps with a checkpoint every
    4 into a temporary directory and a failure injected at step 6: one
    restart, the latest checkpoint at step 12, and the losses of an
    uninterrupted run to 1e-6;
17. (run after 16, before 15's lines) lapis-translate and autotune on the
    card: (a) ``pipeline.main(["--demo", "mlp", "--target", "cuda",
    "--emit", ..., "--emit-cpp", ..., "--run-native"])`` returns 0; each
    of the four demos, compiled for ``cuda``, is emitted as a torch module
    (imported and initialized, every weight on the card, its
    output within 1e-5 of the cuda callable's in f32 and equal for the
    paged copies, no hand kernel launched by it) and as a Kokkos C++ unit
    built by g++ against ``tests/kokkos_stub`` and run on the host, within
    1e-4 of the cuda callable (the build seconds printed); (b)
    ``examples/quickstart_torch.py`` end to end on the card; (c) phase
    13's ResNet18 through ``save_source``: the source's MB, the seconds of
    emit, import and ``lapis_initialize`` (weights on the card), the
    probabilities within rtol 1e-3 / atol 1e-6 of the cuda call with the
    same top-1 classes, and the emitted module's call timed beside the
    compiled cuda and torch calls; (d) autotune on the card into a
    temporary tune cache: SpMV on phase 5's PFlow_742 matrix and the mlp
    demo with ``autotune=True``, each candidate's tiling, launch plan and
    measured us printed with how many launch differently, the decision's
    ``cost.source == "autotune"``, a second compile replaying it with 0
    measurements (the same tiling, cost attrs and C++), the tuned SpMV
    within phase 5's 1e-4 relative of the plain version in f64 and the
    tuned mlp within 1e-5 of the untuned;
18. (run after 17, before 15's lines) the MoE, encoder-decoder and vision
    families at their published widths, each model seeded in its compute
    dtype one layer at a time and freed before the next, at fixed depths
    (``GROK_DEPTH``, ``BF16_CELLS``: full where the weights fit an 80 GB
    card, the cut printed; a cell that does not fit the free memory
    fails), each path's RMSNorm, decode attention and page gather held to
    their plain versions at the path's shapes, bf16 and f32, at phase 7's
    tolerances: (a) grok-1-314b as published (d_model 6144, 48 / 8 heads
    x 128, d_ff 32768, 8 experts top-2 dropless with unrenormalised
    gates, vocab 131072 tied, softcap 30 in prefill and decode, norms
    after each sublayer too, the two multipliers) at 2 of 64 layers
    (its f32 tree fits): the softcapped flash kernel at its prefill shape
    against the plain version; ``serve_paged`` (the engine
    of ``launch.serve.main --paged``) over 8 requests of 64-512 prompt
    tokens and 16 new tokens in 4 slots, monolithic and with
    ``prefill_chunk=128``, through flash attention, RMSNorm, the page
    gather and decode attention with no plain call; each prompt's
    prefill ms (the first's device busy ms and largest kernels from the
    profiler), the decode step's host ms, device busy ms, launches and
    largest kernels, the expert products' share of its device time
    (the grouped kernels, profiler) beside their routed rows, and one
    layer's padded expert FFN (the path training and f32 keep) at the
    step's buffer timed as the step would fill it (8 of 4096 rows) and
    with every row filled; the weights
    widened to f32 in place, one decode step's bf16 logits on both
    targets against the f32 step (phase 8's gate), then the requests'
    f32 greedy tokens on ``cuda`` and ``torch``, equal; (b) whisper-base
    (``launch.serve.main``'s wave loop in bf16, then f32 greedy tokens on
    both targets over the reference's seeded frames, equal; its flash
    kernel at Sq = 1 and at the encoder's 1500 x 1500 timed beside SDPA),
    qwen2-vl-2b (the paged engine in bf16, then f32 greedy tokens after
    the 256-patch vision prefix with its M-RoPE streams, equal), and
    starcoder2-15b, qwen1.5-32b, qwen3-32b and arctic-480b in bf16 (the
    paged engine over 4 requests, then one forward's logits on both
    targets within 3e-2 of the largest; starcoder2's f32 greedy tokens
    too, at 32 of 40 layers, where its f32 tree fits), every path launching its
    kernels with no plain call; (c) ``kernels/ops.py::attention`` on the
    ``torch`` target at 1 x 12 / 2 heads x 4096 x 128, f32 and bf16:
    one call of ``kernels/chunked.py`` each, the flash kernel within
    phase 7's tolerances of it, its time and peak memory beside the
    dense plain block's;
19. (run after 18, before 15's lines) distribution and the dry-run: (a)
    ``repro_torch.benchmarks.machine_peaks`` into a temporary tune cache,
    each ceiling printed beside the data-sheet peaks below (fail unless
    every ceiling is > 0 and the HBM, f32 and bf16 ones are at most 105%
    of the data sheet); then ``python -m repro_torch.launch.dryrun`` for
    qwen2-1.5b's four cells on the 16 x 16 fake-group mesh, one process a
    cell, running on the host's CPU beside (b)-(d); (b) phase 16's first
    ``MESH_STEPS`` steps (its seed, batches and hyperparameters) unmeshed
    on the fused AdamW kernels and on the plain branch, and as DTensors
    (which take the plain branch) on a 1 x 1 (data, model) mesh over a
    world-size-1 NCCL group (state by ``train_state_shardings``, batch by
    ``batch_shardings``): meshed losses and gradient norms within 1e-6
    relative of the unmeshed plain branch's (bitwise equality printed),
    the unmeshed fused losses within 1e-6 of phase 16's, fused and plain
    within phase 16b's bf16 bars (loss 1e-3, gradient norm 1e-2), the
    bf16 flash and RMSNorm kernels launched and no plain call; (c)
    that state saved and ``restore(shardings=...)``-d onto the mesh,
    every leaf bit for bit with its placements; (d) ``make_prefill_step``
    + ``make_decode_step`` on the mesh in f32 over prompts of
    ``SERVE19_PROMPTS`` tokens and ``SERVE19_GEN`` decode steps: the
    greedy tokens equal to ``launch.serve.generate``'s unmeshed, decode
    attention, f32 flash and RMSNorm launched with no plain call, and
    each held to its plain version at these shapes (phase 7's
    tolerances); (e) phase 16's cell (8 x 512, one device) counted on meta
    tensors by ``launch/opcount.py`` (the ``torch`` target's plain
    versions): its roofline time, max(compute, memory) over (a)'s bf16
    and HBM ceilings, beside phase 16's measured step walls (fail if the
    bound exceeds the fastest), then each dry-run cell's status, FLOPs,
    bytes and collective bytes per device, memory, dominant term and
    useful-FLOPs ratio (fail on an errored cell or a record that did not
    read (a)'s peaks), and the phase's wall time;
20. (run after 19, before 15's lines) every compiled path verified, and
    the reference's default mode: (a) the four demos (``cuda``, ``torch``,
    ``auto``), phase 4's qwen2-1.5b block in f32 and bf16 (``cuda``,
    ``auto``), ResNet18 and MALA at phase 13's and 14's shapes, phase 12's
    batched products and lapis-translate's four pinned graphs (``cuda``),
    each compiled again with ``verify_ir="full"``: no error diagnostic
    (one raises), each module's warnings printed, the IR equal to the
    unverified compile's up to SSA ids and the outputs equal bit for bit
    (both calls under ``torch.use_deterministic_algorithms``: the library
    SpMV's ``index_add_`` sums by atomics otherwise); the compile seconds
    with and without;
    (b) the dynamic shared memory of each launch plan (``kk.gemm`` of
    every module above on its route, gemv, the batched products' small
    and tiled plans, both flash kernels at head dims 64, 128 and 256)
    printed beside ``H100_HIERARCHY.scratch_bytes`` (the budget the
    scratch checker holds every tiling to): fail if one exceeds it; (c)
    the qwen2-1.5b block (f32, bf16), the mlp demo and ResNet18 under
    ``torch``, ``cuda``, ``auto`` and ``auto`` with
    ``prefer_library=False``: under ``auto`` no hand GEMM (the library
    intercepts the products), with ``prefer_library=False`` as many as
    ``cuda``; nests launch on ``cuda`` only, one each mapped nest
    (``auto`` collapses them into library calls, as the reference's
    does); no plain call anywhere; each output within phase 4's
    tolerances of ``torch`` (ResNet18: 1e-3 of an f64 evaluation, the
    same top-1 classes); the block's device time (and with the host's
    share) under each route beside the card's name and power limit;
21. (run after 20, before 15's lines) the MoE's grouped expert products
    (``kernels/grouped_gemm.py``, ``csrc/grouped_gemm.cu``) at grok-1's
    decode shapes, one layer (512 tokens' top-2 of 8 experts: 1,024 rows,
    6144 x 32768, bf16): one launch of each kernel and no plain call,
    each within 2^-7 of its plain version's largest entry (down fed the
    plain h), and each timed beside its bound (the experts' weights read
    once), its plain version and, as the library time, the padded
    einsums it replaces over the (32, 8, 128, 6144) buffer;
15. print the ``{"kernels": [...]}`` line (eighteen kernels: flash
    attention's bf16 and f32 kernels are two rows, and so are the bf16
    ``wgmma`` and the FFMA routes of ``kk.gemm`` and of the tiled batched
    product), the card line again, and as the last line ``{"ok": true,
    "device": {...}}``.

Every path is driven with the launch counts set to 0 just before it and
read just after; a kernel's ``launches`` is the sum over the paths.
Every time is measured here with CUDA events (one call per sample, L2
flushed before each, median): kernel times are the device's alone, a
compiled call's time also with the host's share; every bound is computed
here from this run's shapes and the H100 SXM data-sheet peaks below.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks: HBM3 bandwidth, and FP32 outside the tensor
# cores (the rate the FFMA kernels run at)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12    # dense bf16, the tensor cores
T_TOKENS = 2048
# paper Table 6.1: (matrix, rows, mean nonzeros per row, max per row)
TABLE_6_1 = (("StocF-1465", 1_465_137, 14.34, 189),
             ("PFlow_742", 742_793, 50.0, 137),
             ("Elasticity3D", 648_000, 78.33, 81),
             ("audikw_1", 943_695, 82.28, 345))
SPMM_MATRIX, SPMM_COLS = "PFlow_742", 16   # a block Krylov solver's RHS
# the paged step: qwen2-1.5b KV widths, serve.py's block size, 64 slots
# of 4096 positions; block 0 of the pool is the scrap block
KV_HEADS, HEAD_DIM, BLOCK, SLOTS, POSITIONS = 2, 128, 16, 64, 4096
SAMPLES = 15
# phase 7: RMSNorm's rows (rows, width, what they are): the decode steps
# of the three served models and qwen2-1.5b's 2048-token prefill
RMS_SHAPES = ((8, 1536, "qwen2-1.5b decode, 8 slots"),
              (4, 2560, "rwkv6-3b decode, 4 rows"),
              (4, 4096, "recurrentgemma-9b decode, 4 rows"),
              (2048, 1536, "qwen2-1.5b prefill, 2048 tokens"))
SPIN_CYCLES = 2_000_000   # ~1 ms at the H100's clocks: covers the host's enqueue
# phase 8: launch/serve.py's CLI at the full qwen2-1.5b widths
SERVE_ARGS = ["--arch", "qwen2-1.5b", "--paged", "--target", "cuda",
              "--requests", "16", "--slots", "8", "--prompt-len", "512",
              "--gen-len", "32", "--ragged", "--block-size", "16",
              "--seed", "0"]
SERVE_SLOTS, SERVE_BLOCK = 8, 16
# phases 10 and 11: the wave loop (launch.serve.main without --paged) at
# the full widths of the two recurrent families; recurrentgemma-9b's
# 2040-token prompts and 32 new tokens cross its 2048-slot ring's wrap
RWKV_REQUESTS, RWKV_BATCH, RWKV_PROMPT, RWKV_GEN = 8, 4, 512, 32
RG_REQUESTS, RG_BATCH, RG_PROMPT, RG_GEN = 4, 4, 2040, 32
# phase 12: the batched products (A shape, B shape) — paper Fig 6.3's four
# cases, 16384 small matrices, the per-head QKᵀ of one 2048-token qwen2-1.5b
# sequence, and qwen2-1.5b's up-projection on a 3-D activation (B
# broadcast: the same product as phase 4's 2-D gemm)
BATCHED_CASES = (((256, 16, 16), (256, 16, 16)),
                 ((256, 32, 32), (256, 32, 32)),
                 ((64, 64, 64), (64, 64, 64)),
                 ((16, 128, 128), (16, 128, 128)),
                 ((16384, 32, 32), (16384, 32, 32)),
                 ((12, 2048, 128), (12, 128, 2048)),
                 ((8, 256, 1536), (1536, 8960)))
# phases 13 and 14: ResNet18 at full width on Fig 6.2b's batch, and the
# MALA surrogate at its published widths on the paper's 8748 points
RESNET_BATCH, RESNET_RES = 8, 224
MALA_POINTS = 8748
# phase 16: training qwen2-1.5b at full width (steps, batch, sequence),
# the f32 comparison's batch, and the reduced runs' (steps, batch, seq);
# the plain scans' backward is a Python loop over time, so T stays short
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 8, 512
TRAIN_F32_BATCH, TRAIN_F32_STEPS = 4, 3
TRAIN_SMALL = (3, 4, 64)
# phase 18: grok-1-314b's requests, decode slots and new tokens; each
# cell's depth, fixed so that every run measures the same models (the
# full depth where the weights fit, else the cut that they force: grok's
# f32 tree, arctic's bf16 one, starcoder2's f32 one), and the GB its
# caches and activations need beside the weights, checked against the
# card's free memory before the cell (grok: the prefill's capacity
# buffers, 32 groups x 8 experts x 128 slots at 32768 f32 columns;
# arctic: 32 groups of 128 experts x 128 slots); the bf16 cells (arch,
# depth, GB, prompt lengths lo..hi, forward tokens, the f32 greedy run's
# depth or None); attention's length above the chunked threshold
GROK_REQUESTS, GROK_SLOTS, GROK_GEN = 8, 4, 16
GROK_DEPTH, GROK_RESERVE_GB = 2, 24
WHISPER_DEPTH, VL_DEPTH, SMALL_RESERVE_GB = 6, 28, 8
BF16_CELLS = (("starcoder2-15b", 40, 6, 32, 256, 256, 32),
              ("qwen1.5-32b", 64, 6, 32, 256, 256, None),
              ("qwen3-32b", 64, 6, 32, 256, 256, None),
              ("arctic-480b", 1, 40, 16, 64, 61, None))
LONG_S = 4096
# phase 19: the meshed training steps (phase 16's first), the meshed
# serving prompts and decode steps, the dry-run's qwen2-1.5b cells (each
# in a process of its own) and how long they may take
MESH_STEPS = 2
SERVE19_PROMPTS, SERVE19_GEN = (64, 200, 384, 512), 16
DRY_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRY_TIMEOUT_S = 600
# phase 20: the head dims the served models' flash kernels run (whisper-base
# 64; qwen2-1.5b, grok-1-314b and the 32B models 128; recurrentgemma-9b 256)
FLASH_HEAD_DIMS = (64, 128, 256)


class KernelCount:
    """One kernel's launch count on a wrapper that routes to two kernels
    (flash attention, ``kk.gemm`` and the tiled batched product: bf16 to
    a wgmma kernel, f32 to an FFMA one); the plain calls are the
    wrapper's."""

    def __init__(self, fn, attr: str):
        self.fn, self.attr = fn, attr

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.fn, self.attr, n)

    @property
    def plain_calls(self) -> int:
        return self.fn.plain_calls

    @plain_calls.setter
    def plain_calls(self, n: int) -> None:
        self.fn.plain_calls = n


def at_f32(need: tuple) -> tuple:
    """The kernels a path must launch when it computes in f32: flash
    attention then runs the FFMA kernel, not the bf16 wgmma one."""
    return tuple("flash_attention_f32" if n == "flash_attention" else n
                 for n in need)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(bytes_moved: float, ops: float,
          peak_ops: float = PEAK_FP32_PER_S) -> tuple:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` text split into {kernel symbol: its SASS}."""
    parts = re.split(r"Function : (\S+)", text)
    return dict(zip(parts[1::2], parts[2::2]))


def synth_csr(torch, n_rows: int, nnz_mean: float, nnz_max: int, gen):
    """The recipe of benchmarks/spmv_bench.py (Poisson row lengths
    clipped to [1, max], uniform columns, normal values), made on the
    card: (indptr, indices, values) as int32, int32, f32."""
    dev = gen.device
    lens = torch.poisson(torch.full((n_rows,), nnz_mean, device=dev),
                         generator=gen).clamp_(1, nnz_max).to(torch.int32)
    indptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(lens, 0, dtype=torch.int32)
    nnz = int(indptr[-1])
    cols = torch.randint(0, n_rows, (nnz,), generator=gen, device=dev,
                         dtype=torch.int32)
    return indptr, cols, torch.randn(nnz, generator=gen, device=dev)


def small_matrices(np, rng) -> dict:
    """The sparse test matrices as dense arrays: random, half the rows
    empty, one dense row, and empty trailing rows."""
    empty_rows = np.zeros((8, 6), np.float32)
    empty_rows[1] = np.arange(1, 7)
    empty_rows[4, 2], empty_rows[7, 5] = 3.0, -2.0
    dense_row = np.zeros((16, 32), np.float32)
    dense_row[3] = np.linspace(-1, 1, 32)
    dense_row[0, 0], dense_row[9, 31] = 1.0, 5.0
    trailing = np.where(rng.random((300, 64)) < 0.1,
                        rng.standard_normal((300, 64)), 0.0)
    trailing[250:] = 0.0
    return {"random 100x80": np.where(rng.random((100, 80)) < 0.1,
                                      rng.standard_normal((100, 80)), 0.0),
            "empty-rows 8x6": empty_rows, "dense-row 16x32": dense_row,
            "trailing-empty 300x64": trailing}


def fused_adamw_phase(torch, dev, cfg, card: str) -> dict:
    """Phase 16's fused AdamW check (the module docstring): the update
    over ``cfg``'s leaves at full size against the plain branch."""
    from repro_torch.benchmarks import machine_peaks
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.models.model import build_model
    from repro_torch.models.spec import tree_leaves
    from repro_torch.optim import OptimizerConfig

    shapes = [tuple(t.shape) for t in tree_leaves(build_model(cfg).abstract())]
    n = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)

    def rand(shape, scale, dtype=torch.float32, positive=False):
        t = torch.randn(shape, generator=gen, device=dev).mul_(scale)
        return (t.abs_() if positive else t).to(dtype)
    # a state some steps in: bf16 gradients as the backward hands them,
    # f32 master and moments, step 5 of a 100-step cosine
    ps = [rand(s, 0.02) for s in shapes]
    gs = [rand(s, 1e-3, torch.bfloat16) for s in shapes]
    ms = [rand(s, 1e-4) for s in shapes]
    vs = [rand(s, 1e-7, positive=True) for s in shapes]
    step = torch.full((), 5, dtype=torch.int32, device=dev)
    hbm = machine_peaks.measure_bandwidth(1 << 28, 10, 5)
    bound_ms = 28 * n / hbm * 1e3
    print(f"phase 16: fused AdamW over qwen2-1.5b's {len(shapes)} leaves "
          f"({n / 1e9:.3f} B entries; HBM stream {hbm / 1e12:.3f} TB/s "
          "measured here)", flush=True)

    def event_ms(fn, reps=5) -> float:
        out = fn()
        del out
        samples = []
        for _ in range(reps):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
            del out
        return statistics.median(samples)

    stats = {"leaves": len(shapes), "entries": n, "hbm_bytes_per_s": hbm,
             "bound_ms": bound_ms}
    for clip in (0.0, 1.0):
        hp = OptimizerConfig(total_steps=100, warmup_steps=1, clip_norm=clip)
        before = (kadamw.adamw.launches, kadamw.adamw.plain_calls)
        got_p, got_m, got_v, got_step, got_norm, got_lr = kadamw.adamw(
            ps, gs, ms, vs, step, hp)
        torch.cuda.synchronize()
        launched = (kadamw.adamw.launches - before[0],
                    kadamw.adamw.plain_calls - before[1])
        if launched != (2 * len(shapes) + 1, 0):
            fail(f"fused AdamW made (launches, plain calls) {launched}, "
                 f"want ({2 * len(shapes) + 1}, 0)")
        # the plain branch leaf by leaf (its coefficients over the whole
        # tree), each leaf compared and freed before the next
        coef = kadamw.plain_coefficients(gs, step, hp)
        worst, exact = 0.0, True
        for i in range(len(shapes)):
            want = kadamw.plain_leaf(ps[i], gs[i].float(), ms[i], vs[i],
                                     coef, hp)
            for a, b in zip((got_p[i], got_m[i], got_v[i]), want):
                exact = exact and a.dtype == b.dtype and torch.equal(a, b)
                scale = float(b.abs().max())
                worst = max(worst, float((a - b).abs().max()) /
                            max(scale, 1e-30))
            del want
        norm_rel = abs(float(got_norm) - float(coef[0])) / float(coef[0])
        lr_equal = bool(torch.equal(got_lr, coef[3]))
        step_ok = int(got_step) == int(coef[2]) == 6
        del got_p, got_m, got_v, coef
        torch.cuda.empty_cache()
        fused_ms = event_ms(lambda: kadamw.adamw(ps, gs, ms, vs, step, hp))
        plain_ms = event_ms(lambda: kadamw.plain(ps, gs, ms, vs, step, hp),
                            reps=3)
        tag = "clip 1.0" if clip else "no clip"
        print(f"  {tag}: fused {fused_ms:.3f} ms (bound {bound_ms:.3f} ms, "
              f"{bound_ms / fused_ms:.1%} of it), plain branch "
              f"{plain_ms:.3f} ms; bit for bit {exact}; worst leaf "
              f"{worst:.2e} of its largest entry (limit "
              f"{'0' if not clip else '1e-6'}); grad_norm {norm_rel:.2e} "
              f"relative (limit 1e-6); lr equal {lr_equal}; launches "
              f"{launched[0]} ({card})", flush=True)
        if not (step_ok and lr_equal and norm_rel <= 1e-6 and
                (exact if not clip else worst <= 1e-6)):
            fail(f"fused AdamW ({tag}) disagrees with the plain branch")
        stats["no_clip" if not clip else "clip"] = {
            "fused_ms": fused_ms, "plain_ms": plain_ms, "bit_exact": exact,
            "worst_rel": worst, "grad_norm_rel": norm_rel}
    del ps, gs, ms, vs
    torch.cuda.empty_cache()
    return stats


def training_phase(torch, np, dev, get_config, CompileOptions, use_options,
                   reset_counts, counts, path_counts, compare) -> dict:
    """Phase 16 (the module docstring): the training path on the card."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models.model import build_model
    from repro_torch.models.spec import tree_map
    from repro_torch.optim import OptimizerConfig, init_opt_state

    card = card_line()
    stats = {}

    def launches(c, *names) -> dict:
        return {n: c[n][0] for n in names}

    def no_plain(c, what) -> None:
        if any(p for _, p in c.values()):
            fail(f"{what}: a plain version ran on the card: {c}")

    def rel(a, b) -> float:
        return abs(a - b) / max(abs(b), 1e-30)

    def logits_gap(model, params, batch) -> float:
        """max |logits(cuda) - logits(torch)| over max |logits(torch)|:
        the forward on both targets from the same compute tree."""
        out = {}
        with torch.no_grad():
            for target in ("cuda", "torch"):
                with use_options(CompileOptions(target=target)):
                    out[target] = model.forward(params, batch)[0].float()
        gap = float((out["cuda"] - out["torch"]).abs().max()) / \
            float(out["torch"].abs().max())
        if not bool(torch.isfinite(out["cuda"]).all()):
            fail("the training forward's logits are not finite")
        return gap

    cfg = get_config("qwen2-1.5b")
    L = cfg.n_layers

    # (0) the path's kernels against their plain versions at the shapes
    # the training forward gives them: flash on the projections' (B, S,
    # H, hd) viewed as (B, H, S, hd), RMSNorm on the (B, S, d_model)
    # stream; phase 7's tolerances (f32: summation order; bf16: an ulp or
    # two of the output), RMSNorm's × max|plain|
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)

    def rand_t(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    print("phase 16: the training path's kernels at its shapes", flush=True)
    for dtype, b_, tol_att, tol_rms, fa_row in (
            (torch.bfloat16, TRAIN_BATCH, 2e-2, 1e-2, "flash_attention"),
            (torch.float32, TRAIN_F32_BATCH, 2e-4, 2e-5,
             "flash_attention_f32")):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        q = rand_t((b_, TRAIN_SEQ, cfg.n_heads, cfg.head_dim),
                   dtype).transpose(1, 2)
        k, v = (rand_t((b_, TRAIN_SEQ, cfg.n_kv_heads, cfg.head_dim),
                       dtype).transpose(1, 2) for _ in range(2))
        compare(fa_row, fa.flash_attention(q, k, v, causal=True),
                ref.attention(q, k, v, causal=True), tol_att,
                f"flash_attention {b_}x{cfg.n_heads}/{cfg.n_kv_heads}x"
                f"{TRAIN_SEQ}x{cfg.head_dim} causal, strided views {tag}")
        x = rand_t((b_, TRAIN_SEQ, cfg.d_model), dtype)
        w = rand_t((cfg.d_model,), dtype)
        compare("rmsnorm", rn.rmsnorm(x, w), ref.rmsnorm(x, w), tol_rms,
                f"rmsnorm {b_}x{TRAIN_SEQ}x{cfg.d_model} {tag} "
                "(x max|plain|)", relative=True)
        del q, k, v, x, w

    stats["adamw"] = fused_adamw_phase(torch, dev, cfg, card)
    n_leaves = stats["adamw"]["leaves"]

    # (a) qwen2-1.5b at full width, bf16 compute, f32 master, AdamW
    hp = steps_mod.TrainHParams(
        optimizer=OptimizerConfig(total_steps=TRAIN_STEPS, warmup_steps=1),
        remat_policy="none")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = build_model(cfg).n_params()
    # model FLOPs a step: 6 N T for the products, and the attention
    # scores and their use (QK^T and PV, 2 S^2 hd a head each forward,
    # the full square: the flash kernel skips the masked half), times 3
    attn_flops = 3 * 4 * L * TRAIN_BATCH * TRAIN_SEQ ** 2 * cfg.n_heads \
        * cfg.head_dim
    step_flops = 6 * n_params * tokens + attn_flops
    print(f"phase 16: training qwen2-1.5b at full width ({n_params / 1e9:.3f}"
          f" B parameters, bf16 compute, f32 master, AdamW): train_loop "
          f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens on the "
          f"cuda target", flush=True)
    reset_counts()
    adamw_before = (kadamw.adamw.launches, kadamw.adamw.plain_calls)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with use_options(CompileOptions(target="cuda")):
        out = train_mod.train_loop(cfg, steps=TRAIN_STEPS,
                                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, hp=hp,
                                   log_every=0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    c = path_counts["train qwen2-1.5b bf16"] = counts()
    losses = out["losses"]
    got = launches(c, "flash_attention", "rmsnorm")
    want = {"flash_attention": L * TRAIN_STEPS,
            "rmsnorm": (2 * L + 1) * TRAIN_STEPS}
    got["adamw"] = (kadamw.adamw.launches - adamw_before[0],
                    kadamw.adamw.plain_calls - adamw_before[1])
    want["adamw"] = ((2 * n_leaves + 1) * TRAIN_STEPS, 0)
    print(f"  {wall_s:.1f} s with init; losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}; launches "
          f"{ {n: l for n, (l, _) in c.items() if l} }", flush=True)
    no_plain(c, "bf16 training")
    if got != want:
        fail(f"bf16 training launched {got}, want {want} ({L} flash, "
             f"{2 * L + 1} RMSNorm and {2 * n_leaves + 1} fused AdamW a "
             "step, no plain AdamW)")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0]:
        fail(f"bf16 training losses {losses}: want {TRAIN_STEPS} finite, "
             "the last below the first")

    # the same 6 steps (the step train_loop builds, its seed and batches)
    # under the profiler: each step's device busy time and peak memory
    # (torch.profiler's schedule hands over one step a trace)
    busy, peak, by_name = [], [], []

    def on_ready(prof):
        ms = {}
        for ev in prof.key_averages():
            t_us = getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0))
            if t_us > 0:
                ms[ev.key] = t_us / 1e3
        by_name.append(ms)
        busy.append(sum(ms.values()))
        peak.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    model, step = train_mod.build_trainer(cfg, hp)
    data = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH), device=dev)
    state = steps_mod.init_train_state(model, hp, 0, dev)
    out_p = {"losses": [], "step_ms": []}
    torch.cuda.reset_peak_memory_stats()
    with use_options(CompileOptions(target="cuda")), profile(
            activities=[ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=0, active=1,
                              repeat=TRAIN_STEPS),
            on_trace_ready=on_ready) as prof:
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            b = {k: dv.device() for k, dv in data.batch_dualview(i).items()}
            state, met = step(state, b)
            out_p["losses"].append(float(met["loss"]))
            out_p["step_ms"].append((time.perf_counter() - t0) * 1e3)
            prof.step()
    torch.cuda.synchronize()
    del model, step, state, met, b
    if len(busy) != TRAIN_STEPS or not all(b > 0 for b in busy):
        fail(f"the profiler gave {busy} ms of device time for "
             f"{TRAIN_STEPS} training steps")
    per_step = []
    for i, ms in enumerate(out["step_ms"]):
        row = {"wall_ms": ms, "tok_per_s": tokens / (ms / 1e3),
               "model_flops": step_flops,
               "bf16_peak_share": step_flops / (ms / 1e3) / PEAK_BF16_PER_S,
               "device_busy_ms": busy[i], "peak_bytes": peak[i],
               "profiled_wall_ms": out_p["step_ms"][i]}
        per_step.append(row)
        print(f"  step {i}: loss {losses[i]:.5f}, wall {ms:.1f} ms, "
              f"{row['tok_per_s']:.0f} tok/s, {step_flops / 1e12:.2f} TFLOP "
              f"= {row['bf16_peak_share']:.1%} of the bf16 peak; profiled "
              f"run: device busy {busy[i]:.1f} ms of "
              f"{out_p['step_ms'][i]:.1f} ms, peak memory "
              f"{peak[i] / 2**30:.2f} GiB ({card})", flush=True)
    last = by_name[-1]
    top = sorted(last.items(), key=lambda kv: -kv[1])[:8]
    kernel_ms = {k: sum(t for n, t in last.items() if k in n)
                 for k in ("lapis_flash_sm90", "lapis_rmsnorm",
                           "lapis_adamw")}
    print("  largest kernels of the last step (profiler, full names):",
          flush=True)
    for name, t in top:
        print(f"    {t:.3f} ms  {name}", flush=True)
    print(f"  the hand kernels in the last step: bf16 flash "
          f"{kernel_ms['lapis_flash_sm90']:.3f} ms over {L} launches, "
          f"RMSNorm {kernel_ms['lapis_rmsnorm']:.3f} ms over {2 * L + 1} "
          f"(profiler; their backward is the plain versions'), fused AdamW "
          f"{kernel_ms['lapis_adamw']:.3f} ms over {2 * n_leaves + 1}",
          flush=True)
    print(f"  profiled run's losses equal the first run's: "
          f"{out_p['losses'] == losses}", flush=True)
    stats["qwen2_bf16"] = {"losses": losses, "steps": per_step,
                           "top_kernels_ms": top, "hand_kernels_ms": kernel_ms,
                           "wall_s": wall_s, "launches": got,
                           "n_params": n_params, "tokens_per_step": tokens,
                           "profiled_losses": out_p["losses"]}
    torch.cuda.empty_cache()

    # (b) remat: one step with and one without from the same state
    model = build_model(cfg)
    batch = {k: dv.device() for k, dv in SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH), device=dev).batch_dualview(0).items()}
    state = steps_mod.init_train_state(model, hp, 0, dev)
    remat = {}
    for policy in ("none", "nothing"):
        step = steps_mod.make_train_step(
            model, dataclasses.replace(hp, remat_policy=policy))
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with use_options(CompileOptions(target="cuda")):
            new, met = step(state, batch)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        c = path_counts[f"train remat {policy}"] = counts()
        no_plain(c, f"remat {policy}")
        del new, met
        walls = []
        for _ in range(3):             # the steady step, after the first
            t0 = time.perf_counter()
            with use_options(CompileOptions(target="cuda")):
                new, met = step(state, batch)
            float(met["loss"])
            walls.append((time.perf_counter() - t0) * 1e3)
            del new, met
        ms = statistics.median(walls)
        remat[policy] = {"loss": loss, "grad_norm": gnorm, "wall_ms": ms,
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         "launches": launches(c, "flash_attention",
                                              "rmsnorm")}
        torch.cuda.empty_cache()
    print(f"  one step without / with remat (nothing): loss "
          f"{remat['none']['loss']:.6f} / {remat['nothing']['loss']:.6f}, "
          f"grad norm {remat['none']['grad_norm']:.6f} / "
          f"{remat['nothing']['grad_norm']:.6f}, steady wall (median of 3) "
          f"{remat['none']['wall_ms']:.1f} / {remat['nothing']['wall_ms']:.1f}"
          f" ms, peak {remat['none']['peak_bytes'] / 2**30:.2f} / "
          f"{remat['nothing']['peak_bytes'] / 2**30:.2f} GiB, launches "
          f"{remat['none']['launches']} / {remat['nothing']['launches']} "
          f"({card})", flush=True)
    if remat["none"]["launches"] != {"flash_attention": L,
                                     "rmsnorm": 2 * L + 1} or \
            remat["nothing"]["launches"] != {"flash_attention": 2 * L,
                                             "rmsnorm": 4 * L + 1}:
        fail("remat: want 28 / 57 launches without and 56 / 113 with")
    if rel(remat["nothing"]["loss"], remat["none"]["loss"]) > 1e-3 or \
            rel(remat["nothing"]["grad_norm"],
                remat["none"]["grad_norm"]) > 1e-3:
        fail("remat changed the loss or the gradient norm by more than "
             "1e-3 relative")
    stats["remat"] = remat

    # the same bf16 step on the torch target (the plain attention and
    # RMSNorm) from the same state, and the forward's logits on both
    # targets: bf16 rounds each kernel's output and the plain version's
    # apart by an ulp or two, so the limits are bf16-sized: the loss a
    # quarter of bf16's 2^-8, the gradient norm 1e-2, the logits 3e-2 of
    # the largest (about 8 of its ulps); a kernel that computed the wrong function (the wrong mask,
    # scale or head map) moves the logits by their own order
    step = steps_mod.make_train_step(model, hp)
    with use_options(CompileOptions(target="torch")):
        new, met = step(state, batch)
    bf_torch = (float(met["loss"]), float(met["grad_norm"]))
    del new, met
    gap = logits_gap(model, steps_mod.cast_compute(state["params"],
                                                   cfg.compute_dtype), batch)
    d_loss = rel(remat["none"]["loss"], bf_torch[0])
    d_norm = rel(remat["none"]["grad_norm"], bf_torch[1])
    print(f"  bf16 step 0, cuda vs torch target: loss "
          f"{remat['none']['loss']:.7f} / {bf_torch[0]:.7f} ({d_loss:.2e} "
          f"relative, limit 1e-3), grad norm {remat['none']['grad_norm']:.6f}"
          f" / {bf_torch[1]:.6f} ({d_norm:.2e}, limit 1e-2); logits "
          f"max|cuda - torch| / max|torch| {gap:.2e} (limit 3e-2)",
          flush=True)
    if not d_loss <= 1e-3 or not d_norm <= 1e-2 or not gap <= 3e-2:
        fail("bf16 training on the cuda target disagrees with the torch "
             "target")
    stats["bf16_vs_torch"] = {"torch_loss": bf_torch[0],
                              "torch_grad_norm": bf_torch[1],
                              "loss_rel": d_loss, "grad_norm_rel": d_norm,
                              "logits_gap": gap}
    del state, model, batch, step
    torch.cuda.empty_cache()

    # (c) f32 compute at full width: cuda (FFMA flash, RMSNorm) against
    # torch, 3 steps from one carried state (the master kept on the host)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    hp32 = dataclasses.replace(
        hp, compute_dtype="float32",
        optimizer=OptimizerConfig(total_steps=TRAIN_F32_STEPS,
                                  warmup_steps=1))
    model = build_model(cfg32)
    host = tree_map(lambda p: p.cpu(), model.init(0, dev))
    torch.cuda.empty_cache()
    data = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_F32_BATCH, seed=1), device=dev)
    # the forward's logits on both targets from the carried weights:
    # f32 moves only the summation order, so 1e-5 of the largest logit
    # (the CPU tests' bar against the reference)
    params = tree_map(lambda p: p.to(dev), host)
    gap32 = logits_gap(model, params, {
        k: dv.device() for k, dv in data.batch_dualview(0).items()})
    del params
    print(f"  f32 forward, cuda vs torch target: logits max|cuda - torch| / "
          f"max|torch| {gap32:.2e} (limit 1e-5)", flush=True)
    if not gap32 <= 1e-5:
        fail("the f32 training forward on the cuda target disagrees with "
             "the torch target")
    f32 = {}
    for target in ("cuda", "torch"):
        params = tree_map(lambda p: p.to(dev), host)
        state = {"params": params,
                 "opt": init_opt_state(params, hp32.optimizer)}
        del params
        step = steps_mod.make_train_step(model, hp32)
        reset_counts()
        rows = []
        with use_options(CompileOptions(target=target)):
            for i in range(TRAIN_F32_STEPS):
                b = {k: dv.device()
                     for k, dv in data.batch_dualview(i).items()}
                state, met = step(state, b)
                rows.append((float(met["loss"]), float(met["grad_norm"])))
        torch.cuda.synchronize()
        c = counts()
        if target == "cuda":
            path_counts["train qwen2-1.5b f32"] = c
            no_plain(c, "f32 training")
            got = launches(c, "flash_attention_f32", "rmsnorm")
            want = {"flash_attention_f32": L * TRAIN_F32_STEPS,
                    "rmsnorm": (2 * L + 1) * TRAIN_F32_STEPS}
            if got != want:
                fail(f"f32 training launched {got}, want {want}")
        f32[target] = rows
        del state, met, b
        torch.cuda.empty_cache()
    for i in range(TRAIN_F32_STEPS):
        print(f"  f32 step {i}: loss cuda {f32['cuda'][i][0]:.7f} / torch "
              f"{f32['torch'][i][0]:.7f}, grad norm {f32['cuda'][i][1]:.6f} "
              f"/ {f32['torch'][i][1]:.6f}", flush=True)
    # every step's loss within 1e-6 relative (about 8 f32 ulps), its
    # gradient norm within 1e-5: the targets differ in summation order
    # alone
    d_loss = max(rel(a[0], b[0]) for a, b in zip(f32["cuda"], f32["torch"]))
    d_norm = max(rel(a[1], b[1]) for a, b in zip(f32["cuda"], f32["torch"]))
    print(f"  f32 steps, cuda vs torch: worst loss {d_loss:.2e} relative "
          f"(limit 1e-6), worst grad norm {d_norm:.2e} (limit 1e-5)",
          flush=True)
    if not d_loss <= 1e-6 or not d_norm <= 1e-5:
        fail("f32 training on the cuda target disagrees with the torch "
             "target")
    stats["qwen2_f32"] = {"cuda": f32["cuda"], "torch": f32["torch"],
                          "loss_rel": d_loss, "grad_norm_rel": d_norm,
                          "logits_gap": gap32}
    del model, host
    torch.cuda.empty_cache()

    # (d) the recurrent families, reduced, f32 compute
    n_steps, b_, t_ = TRAIN_SMALL
    for arch, need in (("rwkv6-3b", ("rwkv6_scan", "rmsnorm")),
                       ("recurrentgemma-9b", ("rglru_scan",
                                              "flash_attention_f32",
                                              "rmsnorm"))):
        cfg_r = dataclasses.replace(get_config(arch, reduced=True),
                                    compute_dtype="float32")
        hp_r = dataclasses.replace(hp32, optimizer=OptimizerConfig(
            total_steps=n_steps, warmup_steps=1))
        runs = {}
        for target in ("cuda", "torch"):
            reset_counts()
            with use_options(CompileOptions(target=target)):
                runs[target] = train_mod.train_loop(
                    cfg_r, steps=n_steps, batch=b_, seq=t_, hp=hp_r,
                    log_every=0)["losses"]
            torch.cuda.synchronize()
            if target == "cuda":
                c = path_counts[f"train {arch} f32"] = counts()
                no_plain(c, f"{arch} training")
                got = {n: l for n, (l, _) in c.items() if l}
        worst = max(rel(a, b) for a, b in zip(runs["cuda"], runs["torch"]))
        print(f"  {arch} reduced, {n_steps} steps of {b_} x {t_} at f32: "
              f"losses cuda {runs['cuda']} / torch {runs['torch']}, worst "
              f"{worst:.2e} relative (limit 1e-4); launches {got}",
              flush=True)
        if any(got.get(n, 0) == 0 for n in need) or not worst <= 1e-4 or \
                not all(np.isfinite(runs["cuda"])):
            fail(f"{arch} training: launches {got} (want every one of "
                 f"{need}) or losses off by {worst:.2e}")
        stats[f"{arch}_reduced"] = {"cuda": runs["cuda"],
                                    "torch": runs["torch"],
                                    "worst_rel": worst, "launches": got}

    # (e) checkpoints and an injected failure, qwen2-1.5b reduced
    cfg_s = get_config("qwen2-1.5b", reduced=True)
    with tempfile.TemporaryDirectory() as ckpt, \
            use_options(CompileOptions(target="cuda")):
        reset_counts()
        crashed = train_mod.train_loop(cfg_s, steps=12, batch=4, seq=32,
                                       ckpt_dir=ckpt, ckpt_every=4,
                                       log_every=0, inject_failure_at=6)
        path_counts["train checkpoint"] = counts()
        latest = CheckpointManager(ckpt).latest()
        clean = train_mod.train_loop(cfg_s, steps=12, batch=4, seq=32,
                                     log_every=0)
    worst = max(rel(a, b) for a, b in zip(crashed["losses"],
                                          clean["losses"]))
    print(f"  checkpointed run with a failure at step 6: restarts "
          f"{crashed['restarts']}, latest checkpoint {latest}, "
          f"{len(crashed['losses'])} losses, worst {worst:.2e} relative to "
          "an uninterrupted run (limit 1e-6)", flush=True)
    if crashed["restarts"] != 1 or latest != 12 or \
            len(crashed["losses"]) != 12 or not worst <= 1e-6:
        fail("the checkpoint / restart run did not end as an uninterrupted "
             "run")
    no_plain(path_counts["train checkpoint"], "checkpointed training")
    stats["checkpoint"] = {"restarts": crashed["restarts"],
                           "latest": latest, "worst_rel": worst}
    return stats


def _import_path(path: Path, name: str):
    """Import a source file as a fresh module (the emitted modules and
    the example ports)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def translate_phase(ctx) -> dict:
    """Phase 17 (the module docstring): lapis-translate and autotune on
    the card.  ``ctx`` carries main()'s helpers and the ResNet18 of
    phase 13."""
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import costmodel, native, pipeline
    from repro_torch.core.options import CompileOptions
    from repro_torch.kernels import spmv as spmv_mod
    reset_counts, counts, path_counts = (ctx["reset_counts"],
                                         ctx["counts"], ctx["path_counts"])
    time_ms, compare = ctx["time_ms"], ctx["compare"]
    stats = {"demos": {}}
    tmp = Path(tempfile.mkdtemp(prefix="lapis_translate_"))

    # ---- (a) the four demos, emitted from the cuda compile
    print("phase 17a: pipeline.main(['--demo', 'mlp', '--target', 'cuda', "
          "'--emit', ..., '--emit-cpp', ..., '--run-native'])", flush=True)
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pipeline.main(["--demo", "mlp", "--target", "cuda", "--emit",
                            str(tmp / "cli_mlp.py"), "--emit-cpp",
                            str(tmp / "cli_mlp.cpp"), "--run-native"])
    torch.cuda.synchronize()
    c = path_counts["emit cli mlp"] = counts()
    out = buf.getvalue().strip()
    print("  " + out.replace("\n", "\n  "), flush=True)
    if rc != 0 or "max |torch - native|" not in out or \
            "output shape: (8, 10) sum: 8.0" not in out:
        fail(f"pipeline.main --emit / --emit-cpp / --run-native returned {rc}")
    if c["matmul"][0] != 2 or any(p for _, p in c.values()):
        fail(f"the CLI's mlp call launched {c}, want 2 gemms and no plain "
             "call")
    for demo in ("mlp", "spmv", "paged", "paged_swap"):
        fn, specs, example = pipeline._DEMOS[demo]()
        mod = pipeline.compile(fn, *specs,
                               options=CompileOptions(target="cuda"))
        name = mod.graph.name
        reset_counts()
        y = mod(*example)
        torch.cuda.synchronize()
        path_counts[f"emit demo {demo}"] = counts()
        src_path = tmp / f"{demo}_gen.py"
        mod.save_source(str(src_path))
        gen = _import_path(src_path, f"lapis_gen_{demo}")
        gen.lapis_initialize()
        on_card = all(w.device.type == "cuda" for w in gen._WEIGHTS.values())
        reset_counts()
        y_src = getattr(gen, name)(*example)
        torch.cuda.synchronize()
        hand = {k: v for k, v in counts().items() if any(v)}
        limit = 1e-5 if demo in ("mlp", "spmv") else 0.0
        err_src = float((y_src - y).abs().max())
        t0 = time.perf_counter()
        so = native.build_shared(mod.save_cpp(str(tmp / f"{demo}.cpp")), tmp)
        build_s = time.perf_counter() - t0
        y_nat = native.NativeModule(so)(*example)
        err_nat = float(np.max(np.abs(y_nat - y.cpu().numpy())))
        print(f"  demo {demo}: emitted module ({len(gen._WEIGHTS)} weights, "
              f"on the card: {on_card}, device {y_src.device}) vs cuda "
              f"callable {err_src:.3e} (limit {limit:.0e}), hand launches "
              f"{hand or 'none'}; C++ unit built by g++ in {build_s:.2f} s "
              f"(stub), native vs cuda callable {err_nat:.3e} (limit 1e-4)",
              flush=True)
        if not on_card or y_src.device.type != "cuda" or err_src > limit \
                or hand or err_nat > 1e-4 or \
                tuple(y_src.shape) != tuple(y.shape):
            fail(f"the emitted forms of demo {demo} disagree with the cuda "
                 "callable, or a weight is off the card")
        gen.lapis_finalize()
        stats["demos"][demo] = {"source_err": err_src, "native_err": err_nat,
                                "native_build_s": build_s}

    # ---- (b) the quickstart port, end to end on the card
    print("phase 17b: examples/quickstart_torch.py on the card", flush=True)
    qs = _import_path(ROOT / "examples" / "quickstart_torch.py",
                      "quickstart_torch")
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        qs.main([])
    torch.cuda.synchronize()
    c = path_counts["quickstart"] = counts()
    lines = buf.getvalue().strip().splitlines()
    print("  " + "\n  ".join(ln for ln in lines if "OK" in ln
                             or ln.startswith(("output:", "wrote"))),
          flush=True)
    if lines[-1] != "OK" or "generated module output on cuda:0 matches: OK" \
            not in lines or c["matmul"][0] != 2 or \
            any(p for _, p in c.values()):
        fail(f"the quickstart port failed on the card (launches {c})")

    # ---- (c) ResNet18 at full width through save_source
    rn_fn, rn_spec = ctx["rn_fn"], ctx["rn_spec"]
    print(f"phase 17c: ResNet18 at full width {tuple(rn_spec.shape)} f32, "
          "save_source, import, lapis_initialize on the card", flush=True)
    rn_mod = pipeline.compile(rn_fn, rn_spec, name="forward",
                              options=CompileOptions(target="cuda"))
    rn_lib = pipeline.compile(rn_fn, rn_spec,
                              options=CompileOptions(target="torch"))
    xr = torch.from_numpy(np.random.default_rng(2).standard_normal(
        rn_spec.shape).astype(np.float32)).to("cuda")
    reset_counts()
    probs = rn_mod(xr)
    torch.cuda.synchronize()
    path_counts["emit resnet18"] = counts()
    t0 = time.perf_counter()
    rn_path = Path(rn_mod.save_source(str(tmp / "resnet18_gen.py")))
    emit_s = time.perf_counter() - t0
    mb = rn_path.stat().st_size / 1e6
    t0 = time.perf_counter()
    rgen = _import_path(rn_path, "lapis_gen_resnet18")
    import_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rgen.lapis_initialize()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_w = len(rgen._WEIGHTS)
    on_card = all(w.device.type == "cuda" for w in rgen._WEIGHTS.values())
    w_mb = sum(w.numel() * w.element_size()
               for w in rgen._WEIGHTS.values()) / 1e6
    reset_counts()
    probs_src = rgen.forward(xr)
    torch.cuda.synchronize()
    hand = {k: v for k, v in counts().items() if any(v)}
    err = float((probs_src - probs).abs().max())
    ok = (on_card and not hand
          and torch.allclose(probs_src, probs, rtol=1e-3, atol=1e-6)
          and torch.equal(probs_src.argmax(-1), probs.argmax(-1)))
    print(f"  source {mb:.1f} MB ({n_w} weights, {w_mb:.1f} MB of f32, on "
          f"the card: {on_card}); emit {emit_s:.2f} s, import {import_s:.2f}"
          f" s, lapis_initialize {init_s:.2f} s; emitted vs cuda callable: "
          f"max abs err {err:.3e} (limit rtol 1e-3, atol 1e-6), top-1 "
          f"{probs_src.argmax(-1).tolist()} vs {probs.argmax(-1).tolist()}; "
          f"hand launches by the emitted module: {hand or 'none'}",
          flush=True)
    if not ok:
        fail("the emitted ResNet18 module disagrees with the cuda callable")
    t_src = time_ms(lambda: rgen.forward(xr), with_host=True)
    t_cuda = time_ms(lambda: rn_mod(xr), with_host=True)
    t_lib = time_ms(lambda: rn_lib(xr), with_host=True)
    print(f"  call (CUDA events, median of 15, L2 flushed, host incl.): "
          f"emitted module {t_src:.4f} ms, compiled cuda {t_cuda:.4f} ms, "
          f"compiled torch {t_lib:.4f} ms", flush=True)
    stats["resnet18"] = {"source_mb": mb, "weights_mb": w_mb,
                         "emit_s": emit_s, "import_s": import_s,
                         "initialize_s": init_s, "max_abs_err": err,
                         "emitted_ms": t_src, "cuda_ms": t_cuda,
                         "torch_ms": t_lib}
    rgen.lapis_finalize()
    del rgen, rn_mod, rn_lib, probs, probs_src, xr
    rn_path.unlink()
    torch.cuda.empty_cache()

    # ---- (d) autotune on the card, into a temporary tune cache
    cache = tmp / "tune"
    prev_env = os.environ.get("REPRO_TUNE_CACHE")
    os.environ["REPRO_TUNE_CACHE"] = str(cache)
    name, n, mean, mx = next(m for m in TABLE_6_1 if m[0] == SPMM_MATRIX)
    gen_t = torch.Generator(device="cuda")
    gen_t.manual_seed(1)
    ip, cols, vals = synth_csr(torch, n, mean, mx, gen_t)
    xv = torch.randn(n, generator=gen_t, device="cuda")
    max_row = int((ip[1:] - ip[:-1]).max())

    def spmv_fn(ipv, indv, valv, x_):
        from repro_torch.core import ops
        return ops.spmv_csr(ipv, indv, valv, x_, n_rows=n,
                            max_nnz_row=max_row)

    mlp_fn, mlp_specs, (mlp_x,) = pipeline._demo_mlp()
    autotune = {}
    for case, fn, args, opname in (
            (f"spmv {name}", spmv_fn, (ip, cols, vals, xv), "kk.spmv"),
            ("mlp demo", mlp_fn, (mlp_x,), "kk.gemm")):
        print(f"phase 17d: autotune {case} on the card (target cuda, "
              f"top-3, tune cache in a temporary directory)", flush=True)
        opts = CompileOptions(target="cuda", autotune=True)
        specs = mlp_specs if case == "mlp demo" else args
        costmodel.reset_cache_stats()
        t0 = time.perf_counter()
        tuned = pipeline.compile(fn, *specs, options=opts)
        tune_s = time.perf_counter() - t0
        st1 = costmodel.reset_cache_stats()
        tuned_ops = [op for op in tuned.graph.ops if op.opname == opname]
        recs = {}
        for f in sorted(cache.iterdir()):
            rec = json.loads(f.read_text())
            if rec["opname"] == opname:
                recs[tuple(tuple(s) for s in rec["shapes"])] = rec
        for op in tuned_ops:
            cost = op.attrs["cost"]
            if cost.get("source") != "autotune" or "measured_us" not in cost:
                fail(f"{case}: {opname} cost {cost}, want an autotune "
                     "decision with measured_us")
        plans = []
        for rec in recs.values():
            for cand in rec["candidates"]:
                t = cand["tiling"]
                if opname == "kk.spmv":
                    plan = spmv_mod.spmv_plan(n, *spmv_mod.check_tiling(t))
                else:
                    (m_, k_), (_, n_) = rec["shapes"]
                    a_ = torch.empty((m_, k_), device="cuda")
                    b_ = torch.empty((k_, n_), device="cuda")
                    plan = ctx["mm"].plan_for(a_, b_)
                plans.append((json.dumps(rec["shapes"]), plan))
                print(f"  candidate {t}: predicted {cand['predicted_us']} us, "
                      f"measured {cand['measured_us']} us; launch plan "
                      f"{plan}", flush=True)
        by_shape = collections.defaultdict(list)
        for shape, plan in plans:
            by_shape[shape].append(json.dumps(plan, sort_keys=True))
        distinct = {s: len(set(v)) for s, v in by_shape.items()}
        print(f"  {st1['measured']} measurements in {tune_s:.2f} s of "
              f"compile; distinct launches among the candidates per op: "
              f"{list(distinct.values())} (a tie among identical launches "
              "is noise)", flush=True)
        if st1["measured"] < 1:
            fail(f"{case}: autotune measured nothing")
        reset_counts()
        y = tuned(*args)
        torch.cuda.synchronize()
        path_counts[f"autotune {case}"] = counts()
        costmodel.reset_cache_stats()
        again = pipeline.compile(fn, *specs, options=opts)
        st2 = costmodel.reset_cache_stats()
        again_ops = [op for op in again.graph.ops if op.opname == opname]
        same = (st2["measured"] == 0 and st2["hits"] >= len(tuned_ops)
                and [o.attrs["tiling"] for o in again_ops]
                == [o.attrs["tiling"] for o in tuned_ops]
                and [o.attrs["cost"] for o in again_ops]
                == [o.attrs["cost"] for o in tuned_ops]
                and again.emit_cpp_source() == tuned.emit_cpp_source())
        print(f"  replay: {st2['measured']} measurements, {st2['hits']} "
              f"cache hits, same tiling, cost attrs and C++: {same}; "
              f"chosen {[o.attrs['tiling'] for o in tuned_ops]}", flush=True)
        if not same:
            fail(f"{case}: the autotune replay differs from the first "
                 "compile")
        if opname == "kk.spmv":
            a64 = spmv_mod.CsrMatrix(ip, cols, vals.double(), n, n)
            want = spmv_mod.spmv_reference(a64, xv.double()).float()
            err = compare("spmv", y, want, 1e-4,
                          f"tuned spmv {name} vs the plain version in f64",
                          relative=True)
        else:
            plain = pipeline.compile(fn, *specs, options=CompileOptions(
                target="cuda"))(*args)
            err = float((y - plain).abs().max())
            print(f"  tuned vs untuned mlp: max abs err {err:.3e} (limit "
                  "1e-5)", flush=True)
            if err > 1e-5:
                fail("the tuned mlp demo disagrees with the untuned one")
        autotune[case] = {
            "measured": st1["measured"], "compile_s": tune_s,
            "chosen": [o.attrs["tiling"] for o in tuned_ops],
            "cost": [o.attrs["cost"] for o in tuned_ops],
            "candidates": [r["candidates"] for r in recs.values()],
            "distinct_launches": list(distinct.values()), "max_abs_err": err}
        for f in cache.iterdir():
            f.unlink()
    if prev_env is None:
        del os.environ["REPRO_TUNE_CACHE"]
    else:
        os.environ["REPRO_TUNE_CACHE"] = prev_env
    stats["autotune"] = autotune
    del ip, cols, vals, xv
    torch.cuda.empty_cache()
    shutil.rmtree(tmp)
    return stats


def families_phase(ctx) -> dict:
    """Phase 18 (the module docstring): the MoE, encoder-decoder and
    vision families on the card.  ``ctx`` carries main()'s helpers."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.options import CompileOptions, use_options
    from repro_torch.kernels import chunked
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_kv as pk
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import frontends
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import build_model
    from repro_torch.runtime.scheduler import Request
    reset_counts, counts, path_counts = (ctx["reset_counts"],
                                         ctx["counts"], ctx["path_counts"])
    time_ms, compare = ctx["time_ms"], ctx["compare"]
    host_and_wall, device_busy = ctx["host_and_wall"], ctx["device_busy"]
    dev, F = ctx["dev"], torch.nn.functional
    bf = torch.bfloat16
    stats = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)

    def rand_t(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def on(target):
        return use_options(CompileOptions(target=target))

    def free() -> None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def launched(c) -> dict:
        return {n: l for n, (l, _) in c.items() if l}

    def check_path(label, c, need) -> None:
        """Every kernel of ``need`` launched on the path, no plain call."""
        if any(c[n][0] == 0 for n in need) or any(p for _, p in c.values()):
            fail(f"{label} launched {launched(c)}: every one of {need} "
                 "must launch, and no plain version may run")

    def at_depth(arch, layers, itemsize, reserve_gb):
        """The published config at ``layers`` of its layers (the phase's
        fixed depths; widths as published); the phase fails unless its
        weights at ``itemsize`` bytes a parameter and ``reserve_gb`` for
        caches and activations fit the card's free memory."""
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        free_b = torch.cuda.mem_get_info()[0]
        base, one = (build_model(dataclasses.replace(cfg, n_layers=n))
                     .n_params() * itemsize for n in (0, 1))
        weights = base + layers * (one - base)
        what = (f"{weights / 1e9:.1f} GB of weights at {itemsize} bytes a "
                f"parameter, {reserve_gb} GB kept for caches and "
                f"activations, {free_b / 1e9:.1f} GB free")
        if weights + reserve_gb * 1e9 > free_b:
            fail(f"{arch} at {layers} layers does not fit: {what}")
        full = base + cfg.n_layers * (one - base)
        depth = "full depth" if layers == cfg.n_layers else \
            (f"depth cut {cfg.n_layers} -> {layers} layers (the full "
             f"depth's weights: {full / 1e9:.1f} GB)")
        print(f"  {arch}: {depth}; {what}; widths as published", flush=True)
        return dataclasses.replace(cfg, n_layers=layers)

    def hold_path_kernels(what, norms=(), attn=None, paged=False) -> None:
        """The path's kernels at its shapes against their plain versions
        on the same inputs, bf16 and f32, at phase 7's tolerances (the
        page gather exactly): RMSNorm over each (rows, width) of
        ``norms``; with ``attn`` = (cfg, lengths, S), decode attention of
        len(lengths) rows of cfg's heads over (B, Hkv, S, hd) at those
        lengths and, when ``paged``, the page gather of such a pool (16
        positions a page, pages in a shuffled order)."""
        for dtype in (bf, torch.float32):
            f32 = dtype == torch.float32
            tag = "f32" if f32 else "bf16"
            tol_rms, tol_att = (2e-5, 2e-4) if f32 else (1e-2, 2e-2)
            for rows, width in norms:
                x, w = rand_t((rows, width), dtype), rand_t((width,), dtype)
                compare("rmsnorm", rn.rmsnorm(x, w), ref.rmsnorm(x, w),
                        tol_rms, f"rmsnorm {what} {rows}x{width} {tag} "
                        "(x max|plain|)", relative=True)
            if attn is None:
                continue
            acfg, lengths, S = attn
            b, hkv, hd = len(lengths), acfg.n_kv_heads, acfg.head_dim
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            q = rand_t((b, acfg.n_heads, hd), dtype)
            kc, vc = (rand_t((b, hkv, S, hd), dtype) for _ in range(2))
            compare("decode_attention", da.decode_attention(q, kc, vc, lens),
                    ref.decode_attention(q, kc, vc, lens), tol_att,
                    f"decode_attention {what} {b}x{acfg.n_heads}/{hkv}x{hd} "
                    f"S={S} lengths {lengths} {tag}")
            if paged:
                per_slot = S // 16
                pool = rand_t((1 + b * per_slot, hkv, 16, hd), dtype)
                table = (torch.randperm(b * per_slot, generator=gen,
                                        device=dev) + 1).to(torch.int32) \
                    .view(b, per_slot)
                compare("page_gather",
                        pk.page_gather(pool, table, lens, block_size=16),
                        pk.page_gather_torch(pool, table, lens,
                                             block_size=16), 0.0,
                        f"page_gather {what} pool {tuple(pool.shape)} table "
                        f"{tuple(table.shape)} {tag}")
        free()

    def widen(tree) -> None:
        """Each floating leaf of a tree widened to f32 in place, one leaf
        at a time (the bf16 leaf freed as its f32 copy lands)."""
        for k, v in tree.items():
            if isinstance(v, dict):
                widen(v)
            elif v.is_floating_point():
                tree[k] = v.float()

    def engine(model, params, reqs, slots, target, **kw) -> dict:
        """``serve_paged`` over ``reqs`` (fresh copies), the pool sized as
        ``launch.serve.main`` sizes it."""
        per_req = -(-max(len(r.prompt) + r.gen_len for r in reqs) // 16)
        fresh = [Request(rid=r.rid, prompt=r.prompt, gen_len=r.gen_len,
                         arrival=0.0) for r in reqs]
        return serve_mod.serve_paged(
            model, params, fresh, n_slots=slots, block_size=16,
            num_blocks=1 + per_req * (slots + 1),
            options=CompileOptions(target=target), **kw)

    def tokens_of(out) -> dict:
        return {r.rid: list(r.tokens) for r in out["requests"]}

    def requests(cfg, n, lo, hi, gen_len, seed) -> list:
        rng = np.random.default_rng(seed)
        return [Request(rid=i, prompt=rng.integers(
                    1, cfg.vocab_size, int(rng.integers(lo, hi + 1))
                ).astype(np.int32), gen_len=gen_len, arrival=0.0)
                for i in range(n)]

    def forward_gap(model, params, tokens) -> float:
        """One forward's logits, cuda against torch, over the largest."""
        out = {}
        with torch.no_grad():
            for target in ("cuda", "torch"):
                with on(target):
                    out[target] = model.forward(
                        params, {"tokens": tokens})[0].float()
        if not bool(torch.isfinite(out["cuda"]).all()):
            fail("a forward's logits are not finite")
        return float((out["cuda"] - out["torch"]).abs().max()) / \
            float(out["torch"].abs().max())

    # ------------------------------------------------------------ 18a
    print("phase 18a: grok-1-314b at its published widths, depth cut to "
          "hold its f32 tree (the f32 greedy gate)", flush=True)
    cfg = at_depth("grok-1-314b", GROK_DEPTH, 4, GROK_RESERVE_GB)
    model = build_model(cfg)
    n_params = model.n_params()
    print(f"  serving grok-1-314b at its published widths "
          f"(d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
          f"x {cfg.head_dim}, d_ff {cfg.d_ff}, {cfg.n_experts} experts "
          f"top-{cfg.experts_per_tok}, vocab {cfg.vocab_size}, softcap "
          f"{cfg.attn_logit_softcap}), {cfg.n_layers} layers: "
          f"{n_params / 1e9:.2f} B parameters, seeded bf16 leaf by leaf",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, dev, dtype=bf)
    free()
    print(f"  init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)
    # the softcapped flash kernel at grok's prefill shapes (the model's
    # transposed (B, S, H, D) views), phase 7's tolerances
    for dtype, tol, row in ((bf, 2e-2, "flash_attention"),
                            (torch.float32, 2e-4, "flash_attention_f32")):
        q = rand_t((1, 512, cfg.n_heads, cfg.head_dim), dtype).transpose(1, 2)
        k = rand_t((1, 512, cfg.n_kv_heads, cfg.head_dim),
                   dtype).transpose(1, 2)
        v = rand_t((1, 512, cfg.n_kv_heads, cfg.head_dim),
                   dtype).transpose(1, 2)
        kw = {"causal": True, "logit_softcap": cfg.attn_logit_softcap}
        compare(row, fa.flash_attention(q, k, v, **kw),
                ref.attention(q, k, v, **kw), tol,
                f"flash_attention grok 1x{cfg.n_heads}/{cfg.n_kv_heads}x512x"
                f"{cfg.head_dim} softcap {cfg.attn_logit_softcap} "
                f"{'bf16' if dtype == bf else 'f32'}")
    reqs = requests(cfg, GROK_REQUESTS, 64, 512, GROK_GEN, 0)
    # RMSNorm over the decode step's and the longest prefill's rows,
    # decode attention over the paged step's gathered view at its first
    # lengths, and the gather of that pool
    per_slot = -(-(512 + GROK_GEN) // 16)
    hold_path_kernels(
        "grok", norms=((GROK_SLOTS, cfg.d_model), (512, cfg.d_model)),
        attn=(cfg, [len(r.prompt) + 1 for r in reqs[:GROK_SLOTS]],
              16 * per_slot), paged=True)
    need = ("flash_attention", "rmsnorm", "page_gather", "decode_attention")
    grok = {"layers": cfg.n_layers, "params": n_params,
            "prompt_lens": [len(r.prompt) for r in reqs]}
    print(f"  {GROK_REQUESTS} requests, prompts {grok['prompt_lens']} "
          f"(MoE groups {[math.gcd(n, 32) for n in grok['prompt_lens']]}), "
          f"{GROK_GEN} new tokens each, {GROK_SLOTS} slots", flush=True)
    for label, kw in (("grok serve", {}),
                      ("grok serve chunked", {"prefill_chunk": 128})):
        reset_counts()
        t0 = time.perf_counter()
        out = engine(model, params, reqs, GROK_SLOTS, "cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = path_counts[label] = counts()
        check_path(label, c, need)
        if out["tokens"] != GROK_REQUESTS * GROK_GEN:
            fail(f"{label}: {out['tokens']} tokens")
        grok[label] = {"steps": out["steps"], "tok_per_s": out["tok_per_s"],
                       "wall_s": wall, "launches": launched(c)}
        print(f"  [{label}{' --prefill-chunk 128' if kw else ''}] "
              f"{GROK_REQUESTS} requests, {out['tokens']} tokens in "
              f"{out['steps']} decode steps, {out['tok_per_s']:.1f} tok/s; "
              f"{wall:.1f} s; launches {launched(c)}", flush=True)
    prefill_ms = []
    with on("cuda"):
        def prefill(r):
            toks = torch.as_tensor(r.prompt[None], device=dev)
            return model.prefill(params, {"tokens": toks},
                                 max_len=len(r.prompt))
        prefill(reqs[0])
        for r in reqs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(r)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
    with on("cuda"):
        busy, top, _ = device_busy(lambda: prefill(reqs[0]), n=2)
    grok["prefill_ms"] = prefill_ms
    grok["prefill_device_busy_ms"] = busy
    grok["prefill_top_kernels_ms"] = top
    print("  prefill ms per prompt (host clock, synchronized): "
          + ", ".join(f"{n}: {t:.2f}" for n, t in
                      zip(grok["prompt_lens"], prefill_ms))
          + f"; mean {statistics.mean(prefill_ms):.2f}; the "
          f"{grok['prompt_lens'][0]}-token prefill keeps the card busy "
          f"{busy:.3f} ms (profiler)", flush=True)
    print("    largest prefill kernels (ms): " + "; ".join(
        f"{name[:60]} {t:.4f}" for name, t in top), flush=True)

    # a steady decode step: GROK_SLOTS slots at the first prompts' lengths
    # over seeded pools
    n_blocks = 1 + per_slot * (GROK_SLOTS + 1)
    table = (torch.arange(GROK_SLOTS * per_slot, dtype=torch.int32,
                          device=dev) + 1).view(GROK_SLOTS, per_slot)
    lengths = torch.tensor([len(r.prompt) for r in reqs[:GROK_SLOTS]],
                           dtype=torch.int32, device=dev)
    token = torch.randint(1, cfg.vocab_size, (GROK_SLOTS,), generator=gen,
                          device=dev, dtype=torch.int32)
    pools = model.init_paged_cache(n_blocks, 16, device=dev)
    for key in pools:
        pools[key] = [rand_t(p.shape, p.dtype) for p in pools[key]]

    def step(target):
        with on(target):
            return model.paged_decode_step(params, token, pools, table,
                                           lengths, block_size=16)[0]

    step("cuda")
    reset_counts()
    logits_c = step("cuda").float()
    torch.cuda.synchronize()
    sc = path_counts["grok decode step"] = counts()
    per_step = launched(sc)
    # grok-1's norms before and after each sublayer, and the final one
    want = {"decode_attention": cfg.n_layers, "page_gather": 2 * cfg.n_layers,
            "rmsnorm": 4 * cfg.n_layers + 1}
    if any(per_step.get(n) != w for n, w in want.items()) or \
            any(p for _, p in sc.values()):
        fail(f"grok decode step launched {per_step} with plain calls; want "
             f"{want}")
    logits_t = step("torch").float()
    host_t, wall = host_and_wall(lambda: step("cuda"))
    busy, top, by_name = device_busy(lambda: step("cuda"))
    if busy <= 0:
        fail("the profiler saw no kernel time in grok's decode step")
    # the expert products' share: the grouped kernels' device time over
    # the step's busy time (bf16 on the card: the routed rows alone)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step("cuda")
        torch.cuda.synchronize()
    grouped_ms = sum(getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
                     for ev in prof.key_averages()
                     if "lapis_grouped" in ev.key) / 3 / 1e3
    G = math.gcd(GROK_SLOTS, moe_mod.MOE_GROUPS)
    C = moe_mod.capacity(GROK_SLOTS // G, cfg)
    rows_run = GROK_SLOTS * cfg.experts_per_tok
    flops = 2.0 * rows_run * cfg.d_model * cfg.d_ff * 3 * cfg.n_layers
    grok["decode_step"] = {
        "host_ms": host_t, "wall_ms": wall, "device_busy_ms": busy,
        "top_kernels_ms": top, "launches": per_step,
        "expert_grouped_ms": grouped_ms, "expert_share": grouped_ms / busy,
        "expert_rows_run": rows_run, "expert_tflop": flops / 1e12}
    print(f"  decode step ({GROK_SLOTS} slots): device busy {busy:.3f} ms "
          f"(profiler), host {host_t:.3f} ms, synchronized wall {wall:.3f} "
          f"ms (device busy {busy / wall:.0%}); launches per step {per_step}",
          flush=True)
    print(f"    expert products (grouped kernels, profiler): {grouped_ms:.3f} "
          f"ms a step, {grouped_ms / busy:.0%} of the busy time; {rows_run} "
          f"routed rows a layer (the padded path's {G} groups x "
          f"{cfg.n_experts} experts x {C} slots would run "
          f"{G * cfg.n_experts * C}): {flops / 1e12:.3f} TFLOP a step",
          flush=True)
    print("    largest kernels (ms per step): " + "; ".join(
        f"{name[:60]} {t:.4f}" for name, t in top), flush=True)
    # the padded path's three expert products of one layer at the
    # step's buffer shape (training and f32 still take it): on the step's
    # buffer (all but 8 of its rows zero) and on the same shape filled,
    # which is the work the padding costs were every slot real
    moe_p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    filled = rand_t((G, cfg.n_experts, C, cfg.d_model), bf)
    sparse = torch.zeros_like(filled)
    sparse.view(-1, cfg.d_model)[::C * cfg.n_experts // 2] = \
        filled.view(-1, cfg.d_model)[:2 * G]
    t_sparse, t_filled = (time_ms(lambda b=b: moe_mod.expert_ffn(moe_p, b,
                                                                 cfg))
                          for b in (sparse, filled))
    grok["decode_step"]["experts_layer_ms"] = {"padded": t_sparse,
                                               "filled": t_filled}
    print(f"    one layer's expert FFN at the step's buffer ({G} x "
          f"{cfg.n_experts} x {C} x {cfg.d_model}, bf16, CUDA events): "
          f"{t_sparse:.3f} ms with the step's {rows_run} of "
          f"{G * cfg.n_experts * C} rows "
          f"filled, {t_filled:.3f} ms with every row filled", flush=True)
    del filled, sparse, moe_p      # moe_p's views would keep the bf16 tree

    # f32 compute: the weights and pools widened in place (the bf16 tree
    # is freed leaf by leaf); the f32 step on the plain versions is the
    # yardstick of both bf16 steps (phase 8's gate)
    widen(params)
    pools32 = {k: [p.float() for p in v] for k, v in pools.items()}
    del pools
    free()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = build_model(cfg32)
    with on("torch"):
        logits_f32 = model32.paged_decode_step(
            params, token, pools32, table, lengths, block_size=16)[0]
    del pools32
    free()
    err_c = (logits_c - logits_f32).abs()
    err_t = (logits_t - logits_f32).abs()
    print(f"  one decode step, bf16, against the f32 step: cuda target mean "
          f"|err| {float(err_c.mean()):.5f} (max {float(err_c.max()):.4f}), "
          f"torch target {float(err_t.mean()):.5f} (max "
          f"{float(err_t.max()):.4f}) of max|logits| "
          f"{float(logits_f32.abs().max()):.3f} (limit: cuda mean |err| <= "
          "1.25 x torch's)", flush=True)
    if not float(err_c.mean()) <= 1.25 * float(err_t.mean()) or \
            not bool(torch.isfinite(logits_c).all()):
        fail("grok's decode step on the cuda target is less accurate in "
             "bf16 than on the torch target")
    grok["bf16_step_mean_err"] = [float(err_c.mean()), float(err_t.mean())]
    tokens32 = {}
    for target in ("cuda", "torch"):
        reset_counts()
        t0 = time.perf_counter()
        out = engine(model32, params, reqs, GROK_SLOTS, target)
        torch.cuda.synchronize()
        c = counts()
        if target == "cuda":
            path_counts["grok f32"] = c
            check_path("grok f32", c, at_f32(need))
        tokens32[target] = tokens_of(out)
        print(f"  f32 serve_paged on {target}: {out['tokens']} tokens in "
              f"{out['steps']} steps, {time.perf_counter() - t0:.1f} s",
              flush=True)
    same = sum(tokens32["cuda"][i] == tokens32["torch"][i]
               for i in tokens32["cuda"])
    print(f"  f32 greedy tokens, cuda vs torch target: {same} of "
          f"{GROK_REQUESTS} requests equal", flush=True)
    if same != GROK_REQUESTS:
        fail("grok: f32 greedy tokens differ between the cuda and torch "
             "targets")
    grok["f32_requests_equal"] = same
    grok["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak memory {grok['peak_gib']:.1f} GiB", flush=True)
    stats["grok-1-314b"] = grok
    del params, model, model32, logits_c, logits_t, logits_f32
    free()

    # ------------------------------------------------------------ 18b
    def greedy(model, params, batch, gen_len, target) -> list:
        """Prefill + greedy decode on the contiguous cache → the tokens,
        one row a prompt."""
        S = batch["tokens"].shape[1]
        out = []
        with on(target):
            logits, cache = model.prefill(params, batch,
                                          max_len=S + gen_len)
            for i in range(gen_len):
                tok = torch.argmax(logits[:, :model.cfg.vocab_size],
                                   -1).to(torch.int32)
                out.append(tok)
                logits, cache = model.decode_step(params, tok, cache, S + i)
        return torch.stack(out, 1).cpu().tolist()

    def f32_greedy(label, cfg, batch_of, gen_len, need) -> int:
        """The f32 model's greedy tokens on ``cuda`` (counts read into
        ``path_counts[label]``) and on ``torch``: equal row for row."""
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        model32 = build_model(cfg32)
        params32 = model32.init(0, dev, dtype=torch.float32)
        batch = batch_of(cfg32)
        toks = {}
        for target in ("cuda", "torch"):
            reset_counts()
            t0 = time.perf_counter()
            toks[target] = greedy(model32, params32, batch, gen_len, target)
            if target == "cuda":
                c = path_counts[label] = counts()
                check_path(label, c, at_f32(need))
            print(f"  {label} on {target}: {len(toks[target])} x {gen_len} "
                  f"tokens in {time.perf_counter() - t0:.1f} s", flush=True)
        same = sum(a == b for a, b in zip(toks["cuda"], toks["torch"]))
        print(f"  {label} greedy tokens, cuda vs torch target: {same} of "
              f"{len(toks['cuda'])} rows equal", flush=True)
        if same != len(toks["cuda"]):
            fail(f"{label}: greedy tokens differ between the cuda and "
                 "torch targets")
        del params32, model32
        free()
        return same

    def text_batch(cfg, rows, length):
        rng = np.random.default_rng(0)
        return {"tokens": torch.as_tensor(
            rng.integers(1, cfg.vocab_size, (rows, length)),
            dtype=torch.int32, device=dev)}

    def serve_cli(label, argv, need) -> dict:
        """``launch.serve.main(argv)`` with the counts zeroed before and
        read after."""
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = path_counts[label] = counts()
        line = buf.getvalue().strip()
        print(f"  launch.serve.main({' '.join(argv)}): {line}; {wall:.1f} s "
              f"with init; launches {launched(c)}", flush=True)
        if rc != 0 or not re.search(r"\[serve(:continuous)?\] \d+ requests",
                                    line):
            fail(f"{label}: serve.main returned {rc}: {line!r}")
        check_path(label, c, need)
        free()
        return {"line": line, "wall_s": wall, "launches": launched(c)}

    # whisper-base, full depth: the wave loop in bf16, then f32 greedy
    # tokens with the reference's seeded frames; its cross-attention at
    # Sq = 1 over the 1500 frames timed beside SDPA
    print("phase 18b: the other six configs at their published widths",
          flush=True)
    cfg = at_depth("whisper-base", WHISPER_DEPTH, 4, SMALL_RESERVE_GB)
    # its decoder's self-attention over the wave loop's 32 + 16 cached
    # positions (LayerNorm: no RMSNorm on this path)
    hold_path_kernels("whisper", attn=(cfg, [33, 48], 48))
    wh = {"serve": serve_cli(
        "whisper serve",
        ["--arch", "whisper-base", "--target", "cuda", "--requests", "4",
         "--batch", "2", "--prompt-len", "32", "--gen-len", "16",
         "--seed", "0"], ("flash_attention", "decode_attention"))}

    def whisper_batch(cfg32):
        b = text_batch(cfg32, 2, 32)
        b["audio_frames"] = torch.as_tensor(
            np.random.default_rng(0).standard_normal(
                (2, cfg32.encoder_seq, cfg32.d_model)),
            dtype=torch.float32, device=dev)
        return b

    wh["f32_rows_equal"] = f32_greedy(
        "whisper f32", cfg, whisper_batch, 16,
        ("flash_attention", "decode_attention"))
    B_x, H_x, D_x, Se = 4, cfg.n_heads, cfg.head_dim, cfg.encoder_seq
    for sq, what in ((1, "decode cross-attention, Sq = 1"),
                     (Se, "encoder self-attention, non-causal")):
        q = rand_t((B_x, sq, H_x, D_x), bf).transpose(1, 2)
        k = rand_t((B_x, Se, H_x, D_x), bf).transpose(1, 2)
        v = rand_t((B_x, Se, H_x, D_x), bf).transpose(1, 2)
        compare("flash_attention", fa.flash_attention(q, k, v, causal=False),
                ref.attention(q, k, v, causal=False), 2e-2,
                f"flash_attention whisper {what}, {B_x}x{H_x}x{sq}x{Se}x"
                f"{D_x} bf16")
        t_k = time_ms(lambda: fa.flash_attention(q, k, v, causal=False))
        t_p = time_ms(lambda: ref.attention(q, k, v, causal=False))
        t_l = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bytes_n = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound(bytes_n, 4.0 * B_x * H_x * sq * Se * D_x,
                           PEAK_BF16_PER_S)
        print(f"    {what}: kernel {t_k:.4f} ms, plain {t_p:.4f}, SDPA "
              f"{t_l:.4f}, bound {b_ms:.6f} by {b_by}", flush=True)
        wh[f"flash_sq{sq}"] = {"ms": t_k, "plain_ms": t_p, "sdpa_ms": t_l,
                               "bound_ms": b_ms}
    stats["whisper-base"] = wh

    # qwen2-vl-2b, full depth: the paged engine in bf16 (text), then f32
    # greedy tokens after the 256-patch vision prefix with its M-RoPE
    # streams
    cfg = at_depth("qwen2-vl-2b", VL_DEPTH, 4, SMALL_RESERVE_GB)
    hold_path_kernels("qwen2-vl", norms=((4, cfg.d_model),),
                      attn=(cfg, [33, 161, 321, 336], 336), paged=True)
    need = ("flash_attention", "rmsnorm", "decode_attention")
    vl = {"serve": serve_cli(
        "qwen2-vl serve",
        ["--arch", "qwen2-vl-2b", "--paged", "--target", "cuda",
         "--requests", "8", "--slots", "4", "--prompt-len", "320",
         "--gen-len", "16", "--ragged", "--seed", "0"],
        need + ("page_gather",))}

    def vision_batch(cfg32):
        b = text_batch(cfg32, 2, frontends.VISION_PATCHES + 64)
        b["vision_embeds"] = torch.as_tensor(
            np.random.default_rng(1).standard_normal(
                (2, frontends.VISION_PATCHES, cfg32.d_model)),
            dtype=torch.float32, device=dev)
        b["vision_positions"] = torch.as_tensor(
            np.ascontiguousarray(frontends.make_vision_positions(2)),
            device=dev)
        return b

    vl["f32_rows_equal"] = f32_greedy("qwen2-vl f32", cfg, vision_batch, 16,
                                      need)
    stats["qwen2-vl-2b"] = vl

    # the bf16-only configs (and starcoder2's f32 tree at a cut depth):
    # the paged engine over a few requests, then one forward's logits on
    # cuda against torch within 3e-2 of the largest (phase 16b's bar)
    for arch, depth, reserve_gb, lo, hi, fwd_len, f32_depth in BF16_CELLS:
        torch.cuda.reset_peak_memory_stats()
        cfg = at_depth(arch, depth, 2, reserve_gb)
        reqs = requests(cfg, 4, lo, hi, 8, 0)
        norms = ()
        if cfg.norm == "rmsnorm":
            norms = ((4, cfg.d_model), (fwd_len, cfg.d_model)) + \
                (((fwd_len * cfg.n_heads, cfg.head_dim),) if cfg.qk_norm
                 else ())
        hold_path_kernels(
            arch, norms=norms, paged=True,
            attn=(cfg, [len(r.prompt) + 1 for r in reqs],
                  16 * -(-max(len(r.prompt) + 8 for r in reqs) // 16)))
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init(0, dev, dtype=bf)
        free()
        need = ("flash_attention", "page_gather", "decode_attention") + \
            (("rmsnorm",) if cfg.norm == "rmsnorm" else ())
        reset_counts()
        out = engine(model, params, reqs, 4, "cuda")
        torch.cuda.synchronize()
        c = path_counts[f"{arch} serve"] = counts()
        check_path(f"{arch} serve", c, need)
        gap = forward_gap(model, params, text_batch(cfg, 1, fwd_len)
                          ["tokens"])
        st = {"layers": cfg.n_layers, "params": model.n_params(),
              "active_params": model.n_active_params(),
              "tokens": out["tokens"], "steps": out["steps"],
              "tok_per_s": out["tok_per_s"], "launches": launched(c),
              "logits_gap": gap, "s": time.perf_counter() - t0,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"  {arch} ({cfg.n_layers} layers, "
              f"{st['params'] / 1e9:.2f} B parameters, "
              f"{st['active_params'] / 1e9:.2f} B active), bf16: serve_paged "
              f"{out['tokens']} tokens in {out['steps']} steps, "
              f"{out['tok_per_s']:.1f} tok/s, launches {launched(c)}; "
              f"forward of {fwd_len} tokens, cuda vs torch max |diff| "
              f"{gap:.2e} of max|logits| (limit 3e-2); {st['s']:.1f} s",
              flush=True)
        if gap > 3e-2:
            fail(f"{arch}: bf16 forward logits on cuda and torch differ by "
                 f"{gap:.2e} of the largest")
        del params, model
        free()
        if f32_depth:
            cfg32 = at_depth(arch, f32_depth, 4, 4)
            st["f32_layers"] = cfg32.n_layers
            st["f32_rows_equal"] = f32_greedy(
                f"{arch} f32", cfg32, lambda c: text_batch(c, 2, 64), 8,
                tuple(n for n in need if n != "page_gather"))
        stats[arch] = st

    # ------------------------------------------------------------ 18c
    print("phase 18c: attention above 2048 positions on the torch target "
          "(kernels/chunked.py)", flush=True)
    calls = []
    real = chunked.flash_chunked_attention

    def counted(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    chunked.flash_chunked_attention = counted
    try:
        for dtype, tol, row in ((torch.float32, 2e-4, "flash_attention_f32"),
                                (bf, 2e-2, "flash_attention")):
            q = rand_t((1, 12, LONG_S, 128), dtype)
            k = rand_t((1, 2, LONG_S, 128), dtype)
            v = rand_t((1, 2, LONG_S, 128), dtype)
            free()
            base = torch.cuda.memory_allocated()
            peaks, outs = {}, {}
            for form, fn in (
                    ("chunked", lambda: kops.attention(
                        q, k, v, options=CompileOptions(target="torch"))),
                    ("dense", lambda: ref.attention(q, k, v))):
                torch.cuda.reset_peak_memory_stats()
                n0 = len(calls)
                outs[form] = fn()
                torch.cuda.synchronize()
                peaks[form] = (torch.cuda.max_memory_allocated() - base) \
                    / 2**20
                if len(calls) - n0 != (form == "chunked"):
                    fail(f"kops.attention at S = {LONG_S} on torch: "
                         f"{len(calls) - n0} chunked calls for the {form} "
                         "form")
            tag = "f32" if dtype == torch.float32 else "bf16"
            compare(row, fa.flash_attention(q, k, v), outs["chunked"], tol,
                    f"flash_attention against chunked attention 1x12/2x"
                    f"{LONG_S}x128 causal {tag}")
            t_c = time_ms(lambda: kops.attention(
                q, k, v, options=CompileOptions(target="torch")))
            print(f"    {tag}: chunked {t_c:.3f} ms, peak {peaks['chunked']:.1f}"
                  f" MiB above the inputs; dense plain peak "
                  f"{peaks['dense']:.1f} MiB", flush=True)
            stats[f"chunked_{tag}"] = {"ms": t_c, "peak_mib": peaks}
            del q, k, v, outs
            free()
    finally:
        chunked.flash_chunked_attention = real
    return stats


def _whole(t):
    """A DTensor's global value (the tensor itself otherwise)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _bits(t):
    """A tensor's bits as integers of its width (NaNs compare too)."""
    import torch
    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32, 8: torch.int64}
                               [t.element_size()])


def distribution_phase(ctx) -> dict:
    """Phase 19 (the module docstring): distribution and the dry-run."""
    import logging
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.benchmarks import machine_peaks
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import costmodel
    from repro_torch.core.options import CompileOptions, use_options
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import dryrun, opcount
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.model import build_model
    from repro_torch.models.spec import tree_leaves, tree_leaves_with_path
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim import optimizer as optim_mod

    reset_counts, counts, path_counts, compare, dev = (
        ctx["reset_counts"], ctx["counts"], ctx["path_counts"],
        ctx["compare"], ctx["dev"])
    train16 = ctx.get("train_stats", {}).get("qwen2_bf16")
    # DTensor warns of every two-dim redistribution on the 16 x 16 mesh
    logging.getLogger("torch.distributed.tensor._redistribute") \
        .setLevel(logging.ERROR)
    t_phase = time.perf_counter()
    card = card_line()
    stats = {}
    tmp = tempfile.mkdtemp(prefix="lapis_phase19_")
    procs = {}
    try:
        # (a) the card's ceilings, into a temporary tune cache
        tune = os.path.join(tmp, "tune")
        print("phase 19a: repro_torch.benchmarks.machine_peaks on the card, "
              f"into a temporary tune cache ({card})", flush=True)
        prev = os.environ.get("REPRO_TUNE_CACHE")
        os.environ["REPRO_TUNE_CACHE"] = tune
        try:
            t0 = time.perf_counter()
            machine_peaks.main(["--force"])
            peaks_s = time.perf_counter() - t0
        finally:
            if prev is None:
                del os.environ["REPRO_TUNE_CACHE"]
            else:
                os.environ["REPRO_TUNE_CACHE"] = prev
        peaks = costmodel.load_peaks(root=tune)
        sheet = {"bandwidth_bytes_per_s": PEAK_BYTES_PER_S,
                 "flops_per_s": PEAK_FP32_PER_S,
                 "bf16_flops_per_s": PEAK_BF16_PER_S}
        values = peaks.to_dict()
        for name in ("bandwidth_bytes_per_s",
                     "scratch_bandwidth_bytes_per_s", "flops_per_s",
                     "bf16_flops_per_s", "launch_overhead_s",
                     "dispatch_overhead_s"):
            v = values[name]
            beside = (f" = {v / sheet[name]:.1%} of the data sheet's "
                      f"{sheet[name]:.3e}" if name in sheet else "")
            print(f"  {name} {v:.4e}{beside}", flush=True)
            if not v > 0:
                fail(f"phase 19a: {name} measured {v}")
            if name in sheet and v > 1.05 * sheet[name]:
                fail(f"phase 19a: {name} {v:.4e} is above 105% of the "
                     f"data sheet's {sheet[name]:.4e}: a timing fault")
        if not peaks.measured:
            fail("phase 19a: the tune cache holds no measured peaks")
        stats["peaks"] = {**values, "seconds": peaks_s,
                          "data_sheet": sheet}

        # the dry-run's cells, each in a process of its own (a fake
        # group of 256 ranks), running beside 19b-19d on the host's CPU
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   REPRO_TUNE_CACHE=tune)
        dry_out = os.path.join(tmp, "dryrun")
        t_dry = time.perf_counter()
        for shape in DRY_SHAPES:
            log = open(os.path.join(tmp, f"dryrun_{shape}.log"), "w")
            procs[shape] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 "qwen2-1.5b", "--shape", shape, "--mesh", "single",
                 "--out", dry_out], env=env, stdout=log,
                stderr=subprocess.STDOUT), log)

        # (b) phase 16's first steps on a 1 x 1 mesh over NCCL
        cfg = get_config("qwen2-1.5b")
        L = cfg.n_layers
        hp = steps_mod.TrainHParams(
            optimizer=OptimizerConfig(total_steps=TRAIN_STEPS,
                                      warmup_steps=1),
            remat_policy="none")
        model = build_model(cfg)
        step = steps_mod.make_train_step(model, hp)
        data = SyntheticLMDataset(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_BATCH), device=dev)
        batches = [{k: dv.device() for k, dv in
                    data.batch_dualview(i).items()}
                   for i in range(MESH_STEPS)]
        print(f"phase 19b: qwen2-1.5b at full width ({L} layers), "
              f"{MESH_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} (phase "
              "16's seed and batches, bf16 over an f32 master, AdamW) "
              "unmeshed, then as DTensors on a 1 x 1 (data, model) mesh "
              "over a world-size-1 NCCL group", flush=True)
        # the unmeshed steps twice: on the fused AdamW kernels, as phase
        # 16 runs them, and on the plain branch, which DTensor leaves
        # take; the meshed steps are held to the plain branch's (the
        # two branches' norms sum in other orders, and a 1-ulp clip
        # scale moves ~1,600 bf16 weights by an ulp after step 1)
        unmeshed = {}
        for branch in ("fused", "plain"):
            state = steps_mod.init_train_state(model, hp, 0, dev)
            rows = []
            with contextlib.ExitStack() as stack:
                stack.enter_context(use_options(CompileOptions(
                    target="cuda")))
                if branch == "plain":
                    stack.enter_context(mock.patch.object(
                        optim_mod, "_fusable", lambda leaves: False))
                for b in batches:
                    state, met = step(state, b)
                    rows.append((float(met["loss"]),
                                 float(met["grad_norm"])))
            unmeshed[branch] = rows
            del state, met
            torch.cuda.empty_cache()
        plain_run = unmeshed["plain"]
        t0 = time.perf_counter()
        mesh = mesh_mod.make_device_mesh("cuda")
        mesh_s = time.perf_counter() - t0
        shardings = steps_mod.train_state_shardings(mesh, model, hp)
        meshed, walls = [], []
        reset_counts()
        with shd.use_mesh(mesh), use_options(CompileOptions(target="cuda")):
            dstate = shd.distribute_tree(
                steps_mod.init_train_state(model, hp, 0, dev), shardings)
            for b in batches:
                db = shd.distribute_tree(
                    b, steps_mod.batch_shardings(mesh, b))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dstate, met = step(dstate, db)
                meshed.append((float(_whole(met["loss"])),
                               float(_whole(met["grad_norm"]))))
                walls.append((time.perf_counter() - t0) * 1e3)
        c = path_counts["train qwen2-1.5b meshed"] = counts()
        got = {n: c[n][0] for n in ("flash_attention", "rmsnorm")}
        want = {"flash_attention": L * MESH_STEPS,
                "rmsnorm": (2 * L + 1) * MESH_STEPS}
        plain_calls = {n: p for n, (_, p) in c.items() if p}
        bitwise = meshed == plain_run
        p16 = train16["losses"][:MESH_STEPS] if train16 else None
        print(f"  NCCL group + mesh {mesh_s:.2f} s; placements of "
              f"layers/attn/wq: "
              f"{dstate['params']['layers']['attn']['wq'].placements}; "
              f"meshed (loss, grad norm) {meshed}, unmeshed on the plain "
              f"branch {plain_run}, on the fused kernels "
              f"{unmeshed['fused']}, phase 16's losses {p16}; meshed and "
              f"plain bitwise equal: {bitwise}; meshed "
              f"step walls {', '.join(f'{w:.1f}' for w in walls)} ms; "
              f"launches {got}, plain calls {plain_calls} ({card})",
              flush=True)
        if plain_calls:
            fail(f"phase 19b: a plain version ran on the card: "
                 f"{plain_calls}")
        if got != want:
            fail(f"phase 19b: the meshed steps launched {got}, want {want}")
        for (ml, mg), (ul, ug) in zip(meshed, plain_run):
            if abs(ml - ul) > 1e-6 * abs(ul) or abs(mg - ug) > 1e-6 * abs(ug):
                fail("phase 19b: the meshed losses or gradient norms are "
                     "more than 1e-6 from the unmeshed ones")
        if p16 is not None and any(abs(fl - l) > 1e-6 * abs(l) for
                                   (fl, _), l in zip(unmeshed["fused"], p16)):
            fail("phase 19b: the unmeshed fused losses are more than 1e-6 "
                 "from phase 16's")
        # fused against plain: phase 16b's bf16 bars (loss 1e-3, gradient
        # norm 1e-2 relative)
        for (fl, fg), (pl, pg) in zip(unmeshed["fused"], plain_run):
            if abs(fl - pl) > 1e-3 * abs(pl) or abs(fg - pg) > 1e-2 * abs(pg):
                fail("phase 19b: the fused AdamW steps are more than phase "
                     "16b's bf16 bars from the plain branch's")
        stats["meshed_train"] = {"meshed": meshed, "unmeshed": plain_run,
                                 "unmeshed_fused": unmeshed["fused"],
                                 "phase16_losses": p16,
                                 "bitwise": bitwise, "wall_ms": walls,
                                 "launches": got, "mesh_s": mesh_s}

        # (c) that state saved, then restored onto the mesh
        ck = CheckpointManager(os.path.join(tmp, "ckpt"))
        t0 = time.perf_counter()
        ck.save(MESH_STEPS, dstate)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, at = ck.restore(shardings=shardings)
        restore_s = time.perf_counter() - t0
        pairs = list(zip(tree_leaves_with_path(back),
                         tree_leaves(dstate)))
        n_bytes = sum(b.to_local().numel() * b.element_size()
                      for _, b in pairs)
        for (path, a), b in pairs:
            if type(a) is not type(b) or a.placements != b.placements or \
                    a.dtype != b.dtype or a.shape != b.shape or \
                    not torch.equal(_bits(a.to_local()),
                                    _bits(b.to_local())):
                fail(f"phase 19c: leaf {'/'.join(path)} did not come back "
                     "bit for bit with its placements")
        print(f"phase 19c: the meshed state ({len(pairs)} leaves, "
              f"{n_bytes / 2**30:.2f} GiB) saved in {save_s:.1f} s, "
              f"restore(shardings=...) in {restore_s:.1f} s at step {at}: "
              "every leaf bit for bit with its placements", flush=True)
        stats["restore"] = {"leaves": len(pairs), "bytes": n_bytes,
                            "save_s": save_s, "restore_s": restore_s}
        del back, pairs, dstate, met, batches, db
        shutil.rmtree(os.path.join(tmp, "ckpt"), ignore_errors=True)
        torch.cuda.empty_cache()

        # (d) the serving steps on the mesh, f32 compute
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        model = build_model(cfg32)
        params = model.init(0, dev)
        rng = np.random.default_rng(19)
        prompts = [rng.integers(1, cfg32.vocab_size, n)
                   for n in SERVE19_PROMPTS]
        print(f"phase 19d: make_prefill_step + make_decode_step on the mesh,"
              f" qwen2-1.5b f32, prompts of {SERVE19_PROMPTS} tokens, "
              f"{SERVE19_GEN} decode steps each, against launch.serve's "
              "generate unmeshed", flush=True)
        with use_options(CompileOptions(target="cuda")):
            want_tok = [serve_cli.generate(model, params, p[None],
                                           gen_len=SERVE19_GEN,
                                           max_len=len(p) + SERVE19_GEN)
                        for p in prompts]
        dparams = shd.distribute_tree(params, shd.param_shardings(
            mesh, model.abstract(), model.axes()))
        decode = steps_mod.make_decode_step(model)
        got_tok, step_ms = [], []
        reset_counts()
        with shd.use_mesh(mesh), use_options(CompileOptions(target="cuda")):
            for p in prompts:
                S = len(p)
                prefill = steps_mod.make_prefill_step(
                    model, max_len=S + SERVE19_GEN)
                batch = {"tokens": torch.as_tensor(p[None], dtype=torch.int32,
                                                   device=dev)}
                logits, cache = prefill(dparams, shd.distribute_tree(
                    batch, steps_mod.batch_shardings(mesh, batch)))
                toks, length = [], S
                for _ in range(SERVE19_GEN):
                    tok = serve_cli._sample(_whole(logits), cfg32.vocab_size,
                                            True, None)
                    toks.append(tok.cpu().numpy())
                    t0 = time.perf_counter()
                    logits, cache = decode(dparams, shd.distribute(
                        tok, shd.batch_sharding(mesh, (1,))), cache, length)
                    _whole(logits)
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    length += 1
                got_tok.append(np.stack(toks, axis=1))
        c = path_counts["serve qwen2-1.5b meshed f32"] = counts()
        launched = {n: c[n][0] for n in ("decode_attention",
                                         "flash_attention_f32", "rmsnorm")}
        plain_calls = {n: p for n, (_, p) in c.items() if p}
        same = all(np.array_equal(a, b) for a, b in zip(got_tok, want_tok))
        print(f"  greedy tokens equal to the unmeshed path's: {same}; "
              f"launches {launched}, plain calls {plain_calls}; meshed "
              f"decode step median {statistics.median(step_ms):.1f} ms "
              f"(host clock, DTensor dispatch included; {card})", flush=True)
        if not same:
            fail(f"phase 19d: meshed tokens {got_tok} != unmeshed "
                 f"{want_tok}")
        if plain_calls or not all(launched.values()):
            fail(f"phase 19d: launches {launched}, plain calls "
                 f"{plain_calls}: want each kernel launched, no plain call")
        # each kernel against its plain version at these shapes
        gen = torch.Generator(device=dev)
        gen.manual_seed(19)

        def rand_t(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        S = max(SERVE19_PROMPTS)
        q = rand_t(1, cfg.n_heads, cfg.head_dim)
        kc, vc = (rand_t(1, cfg.n_kv_heads, S + SERVE19_GEN, cfg.head_dim)
                  for _ in range(2))
        lens = torch.tensor([S + 1], dtype=torch.int32, device=dev)
        compare("decode_attention", da.decode_attention(q, kc, vc, lens),
                ref.decode_attention(q, kc, vc, lens), 2e-4,
                f"decode_attention 1 x {cfg.n_heads}/{cfg.n_kv_heads} x "
                f"{cfg.head_dim} over {S + 1} of {S + SERVE19_GEN} f32")
        q = rand_t(1, cfg.n_heads, S, cfg.head_dim)
        k, v = (rand_t(1, cfg.n_kv_heads, S, cfg.head_dim)
                for _ in range(2))
        compare("flash_attention_f32", fa.flash_attention(q, k, v,
                                                          causal=True),
                ref.attention(q, k, v, causal=True), 2e-4,
                f"flash_attention 1 x {cfg.n_heads}/{cfg.n_kv_heads} x {S} x "
                f"{cfg.head_dim} causal f32")
        x, w = rand_t(1, S, cfg.d_model), rand_t(cfg.d_model)
        compare("rmsnorm", rn.rmsnorm(x, w), ref.rmsnorm(x, w), 2e-5,
                f"rmsnorm 1 x {S} x {cfg.d_model} f32 (x max|plain|)",
                relative=True)
        stats["meshed_serve"] = {"tokens_equal": same, "launches": launched,
                                 "decode_step_ms": step_ms}
        del params, dparams, logits, cache, q, k, v, kc, vc, x, w
        torch.cuda.empty_cache()

        # (e) phase 16's cell on one device, counted on meta tensors, and
        # the dry-run's cells on the 16 x 16 mesh
        model = build_model(cfg)
        meta = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                               device="meta") for k in ("tokens", "labels")}
        t0 = time.perf_counter()
        with use_options(dryrun.COUNT_OPTIONS):
            _, cnt = opcount.count(steps_mod.make_train_step(model, hp),
                                   steps_mod.abstract_train_state(model, hp),
                                   meta)
        count_s = time.perf_counter() - t0
        roof = dryrun.roofline(cnt, peaks)
        bound_ms = max(roof["compute_s"], roof["memory_s"]) * 1e3
        walls16 = train16["steps"] if train16 else []
        measured = [r["wall_ms"] for r in walls16] or walls
        fastest = min(measured)
        print(f"phase 19e: phase 16's cell ({TRAIN_BATCH} x {TRAIN_SEQ}, one "
              f"device) counted on meta tensors in {count_s:.1f} s: "
              f"{cnt['flops']:.4e} FLOP, {cnt['bytes']:.4e} bytes, peak "
              f"{cnt['peak_bytes'] / 2**30:.2f} GiB live; roofline "
              f"compute {roof['compute_s'] * 1e3:.2f} ms, memory "
              f"{roof['memory_s'] * 1e3:.2f} ms, bound {bound_ms:.2f} ms "
              f"({roof['dominant']}) against phase 16's measured steps "
              f"{', '.join(f'{m:.1f}' for m in measured)} ms (fastest "
              f"{fastest:.1f}: the step takes {fastest / bound_ms:.2f}x "
              f"its bound; {card})", flush=True)
        if bound_ms > fastest:
            fail("phase 19e: the counted bound exceeds the measured step "
                 "(a counting error)")
        stats["phase16_cell"] = {"flops": cnt["flops"], "bytes": cnt["bytes"],
                                 "peak_bytes": cnt["peak_bytes"],
                                 "roofline": roof, "bound_ms": bound_ms,
                                 "measured_ms": measured,
                                 "ratio": fastest / bound_ms,
                                 "count_s": count_s}
        cells = {}
        for shape, (proc, log) in procs.items():
            rc = proc.wait(timeout=DRY_TIMEOUT_S)
            log.close()
            path = os.path.join(dry_out, f"qwen2-1.5b__{shape}__single.json")
            rec = json.load(open(path)) if os.path.exists(path) else {}
            if rc != 0 or rec.get("status") not in ("ok", "skipped"):
                print(open(os.path.join(tmp, f"dryrun_{shape}.log"))
                      .read()[-3000:], flush=True)
                fail(f"phase 19e: the dry-run of {shape} ended rc {rc}, "
                     f"status {rec.get('status')}: {rec.get('error')}")
            cells[shape] = rec
        dry_s = time.perf_counter() - t_dry
        print(f"  the dry-run, qwen2-1.5b on the 16 x 16 mesh (fake group, "
              f"meta tensors, 19a's peaks), its cells in parallel on the "
              f"host, {dry_s:.1f} s from 19a's end:", flush=True)
        for shape, rec in cells.items():
            if rec["status"] == "skipped":
                print(f"    {shape}: skipped ({rec['reason']})", flush=True)
                continue
            r = rec["roofline"]
            print(f"    {shape}: ok in {rec['compile_seconds']} s; per "
                  f"device {rec['flops_per_device']:.4e} FLOP, "
                  f"{rec['bytes_per_device']:.4e} bytes, collectives "
                  f"{rec['collective_bytes_per_device']:.4e} bytes "
                  f"{rec['collective_breakdown']}; memory "
                  f"{rec['memory']['total_bytes'] / 2**30:.2f} GiB; compute "
                  f"{r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, "
                  f"dominant {r['dominant']}, useful_flops_ratio "
                  f"{r['useful_flops_ratio']:.4f}; peaks measured "
                  f"{rec['peaks']['measured']}", flush=True)
            if not rec["peaks"]["measured"]:
                fail(f"phase 19e: {shape}'s record did not read 19a's peaks")
        stats["dryrun"] = {s: {k: rec.get(k) for k in (
            "status", "compile_seconds", "flops_per_device",
            "bytes_per_device", "collective_bytes_per_device",
            "collective_breakdown", "memory", "roofline")}
            for s, rec in cells.items()}
        stats["dryrun_s"] = dry_s
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    stats["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 19: {stats['wall_s']:.1f} s ({card})", flush=True)
    return stats


def ids_normalized(text: str) -> str:
    """IR text with its SSA ids renumbered by first appearance, so two
    compiles of one function compare."""
    ids = {}
    return re.sub(r"%(\d+)", lambda m: "%" + ids.setdefault(
        m.group(1), f"v{len(ids)}"), text)


def translate_graphs(ops, spec, rng) -> dict:
    """The four graphs lapis-translate's goldens pin (a product, a fused
    MLP, SpMV on CSR, a paged swap round trip), their weights seeded:
    name → (fn, specs, example inputs as numpy arrays)."""
    import numpy as np
    wr = np.random.default_rng(7)
    w = wr.standard_normal((16, 8), dtype=np.float32)
    mr = np.random.default_rng(11)
    w1 = mr.standard_normal((16, 32), dtype=np.float32)
    b1 = mr.standard_normal((4, 32), dtype=np.float32)
    w2 = mr.standard_normal((32, 8), dtype=np.float32)
    n, lens = 8, np.array([2, 2, 1, 2, 1, 2, 1, 1])
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    nb, ns, heads, bs, hd = 9, 5, 2, 4, 8

    def matmul(x):
        return ops.matmul(x, ops.constant(w))

    def fused_mlp(x):
        h = ops.relu(ops.add(ops.matmul(x, ops.constant(w1)),
                             ops.constant(b1)))
        return ops.softmax(ops.matmul(h, ops.constant(w2)))

    def spmv(ip, ind, val, x):
        return ops.relu(ops.spmv_csr(ip, ind, val, x, n_rows=n,
                                     nnz_mean=1.5, max_nnz_row=2))

    def paged_swap(pool, swap, pool_ids, swap_ids, fresh_ids):
        swap2 = ops.page_swap_out(swap, pool, pool_ids, swap_ids,
                                  block_size=bs)
        pool2 = ops.page_swap_in(pool, swap2, swap_ids, fresh_ids,
                                 block_size=bs)
        return ops.page_copy(pool2, pool2, fresh_ids, pool_ids,
                             block_size=bs)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {
        "matmul": (matmul, (spec((4, 16), "float32"),), (f32(4, 16),)),
        "fused_mlp": (fused_mlp, (spec((4, 16), "float32"),),
                      (f32(4, 16),)),
        "spmv": (spmv, (spec((n + 1,), "int32"), spec((12,), "int32"),
                        spec((12,), "float32"), spec((n,), "float32")),
                 (indptr, rng.integers(0, n, 12).astype(np.int32),
                  f32(12), f32(n))),
        "paged_swap": (paged_swap,
                       (spec((nb, heads, bs, hd), "float32"),
                        spec((ns, heads, bs, hd), "float32"),
                        spec((2,), "int32"), spec((2,), "int32"),
                        spec((2,), "int32")),
                       (f32(nb, heads, bs, hd), f32(ns, heads, bs, hd),
                        np.array([1, 4], np.int32), np.array([0, 3], np.int32),
                        np.array([6, 7], np.int32)))}


def verification_phase(ctx) -> dict:
    """Phase 20: every compiled path again under ``verify_ir="full"``
    (20a), each launch plan's shared memory against the budget the
    scratch checker holds the tilings to (20b), and the reference's
    default mode, products intercepted by the library, on the card
    (20c).  ``ctx``: main()'s reset_counts, counts, path_counts, time_ms,
    dev, the qwen2-1.5b block (``block``, ``block16``: fn, spec, input),
    rn_fn, rn_spec, rn_w, mala_fn, mala_spec and bmm."""
    import numpy as np
    import torch

    from repro_torch.core import analysis, ops, pipeline
    from repro_torch.core.backend import H100_HIERARCHY
    from repro_torch.core.ir import KOKKOS_PARALLEL_OPS
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.tracer import TensorSpec, torch_dtype
    from repro_torch.kernels import batched_gemm as bgm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.models import resnet
    reset_counts, counts = ctx["reset_counts"], ctx["counts"]
    path_counts, time_ms, dev = ctx["path_counts"], ctx["time_ms"], ctx["dev"]
    budget = H100_HIERARCHY.scratch_bytes
    card = card_line()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(20)

    def on_card(x):
        return x if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def outputs(y) -> list:
        return list(y) if isinstance(y, (tuple, list)) else [y]

    def run_deterministic(mod, args) -> list:
        """One call under torch's deterministic algorithms: the library's
        CSR SpMV sums by ``index_add_``, whose atomics give other bits
        from one call to the next otherwise; cuDNN keeps one algorithm."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                y = outputs(mod(*args))
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        return y

    # ---- 20a: verify_ir="full" on every compiled path
    print("phase 20a: every compiled path compiled again with "
          "verify_ir='full' (dialect verifier + race / sync / scratch / "
          "paged-alias checkers after every pass) and run beside the "
          "unverified module", flush=True)
    cases = []       # (label, fn, specs, target, inputs)
    for demo in sorted(pipeline._DEMOS):
        fn, specs, example = pipeline._DEMOS[demo]()
        for target in ("cuda", "torch", "auto"):
            cases.append((f"demo {demo} {target}", fn, specs, target,
                          example))
    for key in ("block", "block16"):
        fn, spec, xv = ctx[key]
        for target in ("cuda", "auto"):
            cases.append((f"qwen2 block {spec.dtype} {target}", fn, (spec,),
                          target, (xv,)))
    xr = on_card(rng.standard_normal(ctx["rn_spec"].shape).astype(
        np.float32))
    cases.append(("resnet18 cuda", ctx["rn_fn"], (ctx["rn_spec"],), "cuda",
                  (xr,)))
    xm = on_card(rng.standard_normal(ctx["mala_spec"].shape).astype(
        np.float32))
    cases.append(("mala cuda", ctx["mala_fn"], (ctx["mala_spec"],), "cuda",
                  (xm,)))
    for sa, sb in BATCHED_CASES:
        for dt in ("float32", "bfloat16"):
            a = on_card(rng.standard_normal(sa).astype(np.float32)).to(
                getattr(torch, dt))
            b = on_card((rng.standard_normal(sb) * sb[-2] ** -0.5).astype(
                np.float32)).to(getattr(torch, dt))
            cases.append((f"batched {'x'.join(map(str, sa))} @ "
                          f"{'x'.join(map(str, sb))} {dt}", ctx["bmm"],
                          (TensorSpec(sa, dt), TensorSpec(sb, dt)), "cuda",
                          (a, b)))
    for name, (fn, specs, example) in translate_graphs(
            ops, TensorSpec, rng).items():
        cases.append((f"translate {name} cuda", fn, specs, "cuda", example))
    compiled = {}
    verify = {"modules": len(cases), "errors": 0, "warnings": {},
              "compile_s": 0.0, "verified_compile_s": 0.0}
    for label, fn, specs, target, inputs in cases:
        t0 = time.perf_counter()
        plain = pipeline.compile(fn, *specs,
                                 options=CompileOptions(target=target))
        t1 = time.perf_counter()
        ver = pipeline.compile(fn, *specs, options=CompileOptions(
            target=target, verify_ir="full"))
        t2 = time.perf_counter()
        verify["compile_s"] += t1 - t0
        verify["verified_compile_s"] += t2 - t1
        diags = tuple(getattr(ver.graph, "diagnostics", ()))
        errors = [d for d in diags if d.severity == analysis.ERROR]
        n_warn = len(diags) - len(errors)
        same_ir = ids_normalized(str(plain.graph)) == \
            ids_normalized(str(ver.graph))
        args = [on_card(x) for x in inputs]
        ys, yv = run_deterministic(plain, args), run_deterministic(ver, args)
        equal = len(ys) == len(yv) and all(
            torch.equal(p, q) for p, q in zip(ys, yv))
        print(f"  {label}: {len(errors)} errors, {n_warn} warnings; compile "
              f"{(t1 - t0) * 1e3:.1f} ms, verified {(t2 - t1) * 1e3:.1f} "
              f"ms; IR equal: {same_ir}; outputs bit for bit: {equal}",
              flush=True)
        if errors or not same_ir or not equal:
            fail(f"{label}: verification reported {len(errors)} errors, or "
                 "changed the graph or its outputs")
        verify["warnings"][label] = n_warn
        compiled[label] = plain
    print(f"  {len(cases)} modules, 0 errors, "
          f"{sum(verify['warnings'].values())} warnings; compile "
          f"{verify['compile_s']:.2f} s, verified "
          f"{verify['verified_compile_s']:.2f} s", flush=True)

    # ---- 20b: shared memory of each launch plan against the budget
    print(f"phase 20b: each launch plan's dynamic shared memory against "
          f"H100_HIERARCHY.scratch_bytes = {budget} B", flush=True)
    plans = []
    for label, mod in compiled.items():
        for op in mod.graph.ops:
            if op.opname == "kk.gemm" and label.endswith("cuda"):
                (m, k), (_, n) = (o.type.shape for o in op.operands)
                dt = torch_dtype(op.operands[0].type.dtype)
                plans.append((f"kk.gemm {m}x{k}x{n} "
                              f"{op.operands[0].type.dtype} ({label})",
                              mm.gemm_plan(m, n, k, 1, dt, True)))
            elif op.opname == "kk.batched_gemm":
                (a_t, b_t) = (o.type for o in op.operands)
                *batch, m, k = a_t.shape
                n = b_t.shape[-1]
                dt = torch_dtype(a_t.dtype)
                small, _, _, bk, bb = bgm.check_tiling(op.attrs["tiling"],
                                                       m, n)
                if small:
                    plan = bgm.small_plan(m, n, k, math.prod(batch), bb,
                                          dt.itemsize, bk)
                    plan["route"] = "small"
                else:
                    plan = bgm.plan_for(torch.empty(a_t.shape, dtype=dt,
                                                    device=dev),
                                        torch.empty(b_t.shape, dtype=dt,
                                                    device=dev))
                plans.append((f"kk.batched_gemm {label[len('batched '):]}",
                              plan))
    plans.append(("gemv 1000x777 float32",
                  mm.gemm_plan(1000, 1, 777, 1, torch.float32, True)))
    for d_ in FLASH_HEAD_DIMS:
        plans.append((f"flash_attention bf16 D={d_} (wgmma)",
                      dict(fa.sm90_plan(d_), route="wgmma")))
        plans.append((f"flash_attention f32 D={d_} (FFMA)",
                      dict(fa.ffma_plan(d_), route="ffma")))
    seen = {}
    for label, plan in plans:
        key = (label.split(" (")[0], plan["route"], plan["smem_bytes"])
        if key in seen:
            continue
        seen[key] = plan["smem_bytes"]
        print(f"  {label}: route {plan['route']}, {plan['smem_bytes']} B "
              f"shared ({plan['smem_bytes'] / budget:.1%} of the budget)",
              flush=True)
    worst = max(p["smem_bytes"] for _, p in plans)
    if worst > budget:
        fail(f"a launch plan takes {worst} B of shared memory, over "
             f"H100_HIERARCHY.scratch_bytes = {budget} B")
    print(f"  largest: {worst} B of {budget} B ({len(seen)} distinct plans)",
          flush=True)

    # ---- 20c: the library-interception mode (target="auto") on the card
    print("phase 20c: target='auto' (products intercepted by the library "
          "while prefer_library) against 'cuda' and 'torch'", flush=True)

    def to64(t):
        return ({k: to64(v) for k, v in t.items()} if isinstance(t, dict)
                else t.double())
    rn_w64 = to64(ctx["rn_w"])
    probs64 = pipeline.compile(
        lambda xv: resnet.resnet18_forward(rn_w64, xv),
        TensorSpec(ctx["rn_spec"].shape, "float64"),
        options=CompileOptions(target="torch"))(xr.double())
    del rn_w64

    def rel_err(p, want) -> float:
        keep = want.double() > 1e-6
        return float(((p.double() - want.double()).abs()
                      / want.double())[keep].max())
    demo_fn, demo_specs, demo_x = pipeline._demo_mlp()
    workloads = {   # name → (fn, specs, inputs)
        "qwen2 block float32": (ctx["block"][0], (ctx["block"][1],),
                                (ctx["block"][2],)),
        "qwen2 block bfloat16": (ctx["block16"][0], (ctx["block16"][1],),
                                 (ctx["block16"][2],)),
        "mlp demo": (demo_fn, demo_specs, tuple(map(on_card, demo_x))),
        "resnet18": (ctx["rn_fn"], (ctx["rn_spec"],), (xr,))}
    modes = (("torch", {}), ("cuda", {}), ("auto", {}),
             ("auto", {"prefer_library": False}))
    interception = {}
    for name, (fn, specs, args) in workloads.items():
        runs = {}
        for target, kw in modes:
            mode = target + ("" if kw.get("prefer_library", True)
                             else " prefer_library=False")
            mod = pipeline.compile(fn, *specs, options=CompileOptions(
                target=target, **kw))
            reset_counts()
            y = mod(*args)
            torch.cuda.synchronize()
            c = path_counts[f"20c {name} {mode}"] = counts()
            mapped = sum(1 for op in mod.graph.ops
                         if op.opname in KOKKOS_PARALLEL_OPS
                         and not op.attrs.get("collapse"))
            runs[mode] = {"mod": mod, "y": y, "counts": c,
                          "gemm": c["matmul"][0] + c["matmul_bf16"][0],
                          "nests": c["block_map_region"][0]
                          + c["row_softmax"][0], "mapped_nests": mapped,
                          "plain": sum(p for _, p in c.values())}
        lib = runs["torch"]["y"]
        for mode, r in runs.items():
            y = r["y"]
            if name == "resnet18":
                err = rel_err(y, probs64)
                ok = err <= 1e-3 and torch.equal(y.argmax(-1),
                                                 lib.argmax(-1))
                what = "max rel err against f64 (limit 1e-3), top-1 equal"
            else:
                tol = (2e-2 if y.dtype == torch.bfloat16 else
                       1e-4 if name.startswith("qwen2") else 1e-5)
                err = float((y.float() - lib.float()).abs().max())
                limit = tol * (float(lib.float().abs().max())
                               if name.startswith("qwen2") else 1.0)
                ok = err <= limit
                what = f"max abs err against torch (limit {limit:.3e})"
            ok = ok and bool(torch.isfinite(y).all()) and \
                y.shape == lib.shape
            print(f"  {name}, {mode}: launch_count {r['mod'].launch_count}, "
                  f"hand GEMM launches {r['gemm']}, nest launches "
                  f"{r['nests']} ({r['mapped_nests']} mapped nests), plain "
                  f"calls {r['plain']}; {what} {err:.3e}", flush=True)
            if not ok:
                fail(f"{name} on {mode} disagrees with the torch target")
            if r["plain"] or r["nests"] != r["mapped_nests"] or \
                    (mode != "cuda" and r["nests"]):
                fail(f"{name} on {mode}: {r['nests']} nest launches for "
                     f"{r['mapped_nests']} mapped nests, {r['plain']} plain "
                     "calls")
        if runs["auto"]["gemm"] or runs["torch"]["gemm"]:
            fail(f"{name}: target auto launched {runs['auto']['gemm']} hand "
                 "GEMMs with prefer_library=True")
        if runs["auto prefer_library=False"]["gemm"] != runs["cuda"]["gemm"]:
            fail(f"{name}: auto with prefer_library=False launched "
                 f"{runs['auto prefer_library=False']['gemm']} hand GEMMs, "
                 f"cuda {runs['cuda']['gemm']}")
        interception[name] = {m: {"launch_count": r["mod"].launch_count,
                                  "gemm_launches": r["gemm"],
                                  "nest_launches": r["nests"]}
                              for m, r in runs.items()}
        if name.startswith("qwen2"):
            times = {}
            for mode, r in runs.items():
                times[mode] = {
                    "device_ms": time_ms(lambda: r["mod"](*args)),
                    "ms": time_ms(lambda: r["mod"](*args), with_host=True)}
            print(f"  {name} T={T_TOKENS}, device ms (with the host's "
                  "share): " + "; ".join(
                      f"{m} {t['device_ms']:.4f} ({t['ms']:.4f})"
                      for m, t in times.items()) + f" [{card}]", flush=True)
            interception[name]["times"] = times
        del runs
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"phase 20: {wall:.1f} s ({card})", flush=True)
    return {"verify": verify, "largest_smem_bytes": worst,
            "smem_budget_bytes": budget, "plans": {
                k[0]: v for k, v in seen.items()},
            "interception": interception, "wall_s": wall}


def grouped_experts_phase(ctx) -> dict:
    """Phase 21 (the module docstring): the MoE's grouped expert products
    at grok-1's decode shapes, one layer: 512 tokens' top-2 of 8 experts
    (1,024 rows, ~128 an expert), bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import activation
    dev, time_ms, compare = ctx["dev"], ctx["time_ms"], ctx["compare"]
    cfg = get_config("grok-1-314b")
    M, Fw, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.experts_per_tok
    T, R, bf = 512, 512 * cfg.experts_per_tok, torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)

    def rand(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=bf).mul_(scale)
    wg, wu = rand((E, M, Fw), M ** -0.5), rand((E, M, Fw), M ** -0.5)
    wd = rand((E, Fw, M), Fw ** -0.5)
    choice = torch.randn((T, E), generator=gen, device=dev).topk(
        k, dim=1).indices.flatten()
    loads = torch.bincount(choice, minlength=E)
    offsets = F.pad(loads.cumsum(0), (1, 0)).to(torch.int32)
    x = rand((R, M), 1.0)
    print(f"phase 21: grouped expert products, grok-1 decode, one layer: "
          f"{R} rows over {E} experts, loads {loads.tolist()}", flush=True)
    ctx["reset_counts"]()
    h = gg.gate_up(x, wg, wu, offsets, cfg.act)
    y = gg.down(h, wd, offsets)
    torch.cuda.synchronize()
    c = ctx["path_counts"]["grouped experts (grok decode)"] = ctx["counts"]()
    if c["grouped_gate_up"] != (1, 0) or c["grouped_down"] != (1, 0):
        fail(f"the grouped products launched {c['grouped_gate_up']} / "
             f"{c['grouped_down']} (launches, plain calls); want (1, 0)")
    want_h = gg.plain_gate_up(x, wg, wu, offsets, cfg.act)
    compare("grouped_gate_up", h, want_h, 2 ** -7,
            "grouped gate_up (grok decode, bf16)", relative=True)
    want_y = gg.plain_down(want_h, wd, offsets)
    compare("grouped_down", gg.down(want_h, wd, offsets), want_y, 2 ** -7,
            "grouped down (grok decode, bf16)", relative=True)
    del y, want_y
    # the padded einsums they replace, over the (G, E, C, M) buffer the
    # padded path fills at 512 tokens (32 x 8 x 128 slots)
    G = math.gcd(T, moe_mod.MOE_GROUPS)
    C = moe_mod.capacity(T // G, cfg)
    buf = torch.zeros((G, E, C, M), dtype=bf, device=dev)
    buf.view(-1, M)[:R] = x
    act = activation(cfg.act)

    def padded_gate_up():
        return act(torch.einsum("gecm,emf->gecf", buf, wg)) \
            * torch.einsum("gecm,emf->gecf", buf, wu)
    h_buf = padded_gate_up()
    stats = {"loads": loads.tolist(), "padded_rows": G * E * C}
    w_bytes = 2.0 * E * M * Fw
    for name, kern, plain, lib, ops_n, bytes_n in (
            ("grouped_gate_up",
             lambda: gg.gate_up(x, wg, wu, offsets, cfg.act),
             lambda: gg.plain_gate_up(x, wg, wu, offsets, cfg.act),
             padded_gate_up, 4.0 * R * M * Fw,
             2 * w_bytes + 2.0 * R * (M + Fw)),
            ("grouped_down", lambda: gg.down(h, wd, offsets),
             lambda: gg.plain_down(h, wd, offsets),
             lambda: torch.einsum("gecf,efm->gecm", h_buf, wd),
             2.0 * R * M * Fw, w_bytes + 2.0 * R * (M + Fw))):
        t_k, t_p, t_l = time_ms(kern), time_ms(plain), time_ms(lib)
        b_ms, b_by = bound(bytes_n, ops_n, PEAK_BF16_PER_S)
        ctx["add_row"](name, t_k, t_p, t_l, ops_n, bytes_n)
        ctx["rows"][name]["peak"] = PEAK_BF16_PER_S
        stats[name] = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                       "bound_ms": b_ms, "bound_by": b_by}
        print(f"  {name}: {t_k:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
              f"{b_ms / t_k:.1%} of it), plain {t_p:.4f} ms, the padded "
              f"einsums it replaces {t_l:.4f} ms", flush=True)
    del wg, wu, wd, buf, h_buf, h, want_h, x
    torch.cuda.empty_cache()
    return stats


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch sees no CUDA card", flush=True)
        return 2
    import numpy as np

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import ops, pipeline, refs
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.tracer import TensorSpec
    from repro_torch.core.options import use_options
    from repro_torch.kernels import _build, generic, ref
    from repro_torch.kernels import batched_gemm as bgm
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_kv as pk
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import row_reduce
    from repro_torch.kernels import rwkv6 as rw
    from repro_torch.kernels import spmm as spmm_mod
    from repro_torch.kernels import spmv as spmv_mod
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.mlp import gated_mlp_block
    from repro_torch.models import resnet
    from repro_torch.models.model import build_model
    from repro_torch.core.dualview import TRANSFERS, reset_transfer_stats

    # the plain versions are held to full f32 as well
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    wrappers = {"matmul": KernelCount(mm.matmul, "launches_ffma"),
                "matmul_bf16": KernelCount(mm.matmul, "launches_wgmma"),
                "block_map_region": generic.block_map_region,
                "row_softmax": generic.row_softmax,
                "spmv": spmv_mod.spmv, "spmm": spmm_mod.spmm_sparse,
                "page_gather": pk.page_gather, "rmsnorm": rn.rmsnorm,
                "decode_attention": da.decode_attention,
                "flash_attention": KernelCount(fa.flash_attention,
                                               "launches_sm90"),
                "flash_attention_f32": KernelCount(fa.flash_attention,
                                                   "launches_ffma"),
                "rwkv6_scan": rw.rwkv6_scan, "rglru_scan": rg.rglru_scan,
                "batched_gemm_small": bgm.batched_gemm_small,
                "batched_gemm_tiled": KernelCount(bgm.batched_gemm_tiled,
                                                  "launches_ffma"),
                "batched_gemm_tiled_bf16": KernelCount(
                    bgm.batched_gemm_tiled, "launches_wgmma"),
                "grouped_gate_up": gg.gate_up, "grouped_down": gg.down}
    path_counts = {}     # path -> counts() read just after driving it

    def reset_counts() -> None:
        for w in wrappers.values():
            w.launches = 0
            w.plain_calls = 0

    def counts() -> dict:
        return {n: (w.launches, w.plain_calls) for n, w in wrappers.items()}

    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(fn, with_host: bool = False) -> float:
        """Median over SAMPLES of one call between CUDA events, the 50 MB
        L2 flushed before each (the main path meets these inputs cold).
        By default the card spins (~1 ms) before the start event, so the
        host has enqueued the call before the card reaches it and the
        time is the device's alone; ``with_host`` drops the spin, so a
        host slower than the card shows in the time (what a caller of
        the compiled module waits)."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(SAMPLES):
            flush_buf.zero_()
            if not with_host:
                torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        return statistics.median(samples)

    def host_and_wall(fn, n=10):
        """(host ms, synchronized wall ms) of one step started on an idle
        card: the host time is the Python call's, which returns once
        every kernel of the step is enqueued (a step launches more
        kernels than the card's queue holds, so a card held busy would
        block the host, and time it would measure is the card's)."""
        host, wall = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append((t1 - t0) * 1e3)
            wall.append((t2 - t0) * 1e3)
        return statistics.median(host), statistics.median(wall)

    def device_busy(fn, n=5):
        """Kernel time per step from the profiler (the card's busy time,
        gaps excluded), the five largest kernels by time, and every
        kernel's time by name (ms per step)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.key_averages():
            t_us = getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0))
            if t_us > 0:
                by_name[ev.key] = t_us / n / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        return sum(by_name.values()), top, by_name

    def rms_ms(by_name: dict, kernel: str = "lapis_rmsnorm") -> float:
        """RMSNorm's device ms per step: every lapis_rmsnorm kernel (or
        every kernel whose name holds ``kernel``)."""
        return sum(t for k, t in by_name.items() if kernel in k)

    def on_card(arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    def plan_line(plan: dict) -> str:
        """A GEMM launch plan (kernels/matmul.py::gemm_plan) in one line."""
        return (f"route {plan['route']}, tile {plan['bm']}x{plan['bn']}x"
                f"{plan['bk']}, {plan['threads']} threads, split "
                f"{plan['split']}, grid {plan['grid']}, smem "
                f"{plan['smem_bytes']} B")

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def row_plan(kind: str, n_rows: int, width: int, dtype) -> dict:
        """The row reductions' launch plan (kernels/row_reduce.py) for a
        contiguous, aligned (n_rows, width) tensor, failing unless the
        library's exported C plan is the same on this card."""
        if kind == "rmsnorm":
            ks, fn, twin = rn.rmsnorm_kernel(), "lapis_rmsnorm_plan", \
                rn.rms_plan
        else:
            ks, fn, twin = generic.softmax_kernel(), \
                "lapis_row_softmax_plan", generic.softmax_plan
        want = twin(n_rows, width, dtype, sms)
        got = row_reduce.c_plan(_build.load(ks), fn, n_rows, width,
                                dtype.itemsize, True, sms)
        if got != want:
            fail(f"{fn}({n_rows}, {width}) = {got}, its twin {want}")
        return want

    def spmv_plan(n_rows: int, tiling: dict) -> dict:
        """SpMV's launch plan (kernels/spmv.py::spmv_plan) for 16-byte
        aligned CSR arrays, failing unless the library's C plan is the
        same."""
        rb, rw = spmv_mod.check_tiling(tiling)
        want = spmv_mod.spmv_plan(n_rows, rb, rw)
        got = spmv_mod.c_plan(n_rows, rb, rw)
        if got != want:
            fail(f"lapis_spmv_plan({n_rows}, {rb}, {rw}) = {got}, its twin "
                 f"{want}")
        return want

    def map_plan(region, args, shape) -> dict:
        """A nest's launch plan (kernels/generic.py::map_plan) for fresh
        (aligned) operands, failing unless its library's C plan is the
        same."""
        n_el = int(np.prod(shape))
        its = [a.element_size() for a in args] + [args[0].element_size()]
        lib = generic.region_library(region, [a.dtype for a in args],
                                     args[0].dtype)
        want = generic.map_plan(n_el, its, True, sms)
        got = generic.c_map_plan(lib, n_el, its, True, sms)
        if got != want:
            fail(f"lapis_map_plan({n_el}) = {got}, its twin {want}")
        return want

    def spmm_plan(n_rows: int, n_: int, tiling: dict, item: int) -> dict:
        """SpMM's launch plan (kernels/spmm.py::spmm_plan) for aligned
        operands, failing unless the library's C plan is the same."""
        rb, _ = spmv_mod.check_tiling(tiling)
        want = spmm_mod.spmm_plan(n_rows, n_, rb, item)
        got = spmm_mod.c_plan(n_rows, n_, rb, item)
        if got != want:
            fail(f"lapis_spmm_plan({n_rows}, {n_}, {rb}) = {got}, its twin "
                 f"{want}")
        return want

    def rglru_plan(b_: int, t_: int, d_: int, dtype) -> dict:
        """The RG-LRU scan's launch plan (kernels/rglru.py::rglru_plan) on
        this card, failing unless the library's C plan is the same."""
        want = rg.rglru_plan(b_, t_, d_, dtype, sms)
        got = rg.c_plan(b_, t_, d_, dtype, sms)
        if got != want:
            fail(f"lapis_rglru_plan({b_}, {t_}, {d_}) = {got}, its twin "
                 f"{want}")
        return want

    def ffma_flash_plan(d_: int) -> dict:
        """The f32 flash kernel's launch plan for head dim ``d_``
        (kernels/flash_attention.py::ffma_plan), failing unless the
        library's C plan is the same; with the blocks an SM the card
        holds."""
        want = fa.ffma_plan(d_)
        got = fa.c_ffma_plan(d_)
        if got != want:
            fail(f"lapis_flash_f32_plan({d_}) = {got}, its twin {want}")
        return dict(want, resident=fa.ffma_occupancy(d_))

    def wkv_plan(b_: int, t_: int, h_: int, k_: int, v_: int, dtype) -> dict:
        """The WKV scan's launch plan (kernels/rwkv6.py::wkv_plan),
        failing unless the library's C plan is the same."""
        want = rw.wkv_plan(b_, t_, h_, k_, v_, dtype)
        got = rw.c_plan(b_, t_, h_, k_, v_, dtype)
        if got != want:
            fail(f"lapis_rwkv6_plan({b_}, {t_}, {h_}, {k_}, {v_}) = {got}, "
                 f"its twin {want}")
        return want

    def row_plan_line(p: dict) -> str:
        return (f"{p['path']} path: {p['tpr']} threads a row x {p['vpt']} "
                f"vectors of {p['vec']}, {p['rows_per_block']} rows a block "
                f"of {p['threads']}, grid {p['grid']}")

    # ---------------------------------------------------------------- 1
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    cfg = get_config("qwen2-1.5b")
    d, d_ff = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(0)
    params_np = {   # xavier, as the reference's gated_mlp_spec
        "w_gate": (rng.standard_normal((d, d_ff)) / np.sqrt(d)),
        "w_up": (rng.standard_normal((d, d_ff)) / np.sqrt(d)),
        "w_down": (rng.standard_normal((d_ff, d)) / np.sqrt(d_ff)),
    }
    params = convert.from_numpy_tree(
        {k: v.astype(np.float32) for k, v in params_np.items()}, dev)
    x_np = rng.standard_normal((T_TOKENS, d)).astype(np.float32)
    x = on_card(x_np)

    def block(xv):
        return gated_mlp_block(params, xv, act=cfg.act)

    spec = TensorSpec((T_TOKENS, d), "float32")
    mod = pipeline.compile(block, spec, options=CompileOptions(target="cuda"))
    mod_lib = pipeline.compile(block, spec,
                               options=CompileOptions(target="torch"))
    params16 = {k: v.bfloat16() for k, v in params.items()}

    def block16(xv):
        return gated_mlp_block(params16, xv, act=cfg.act)

    spec16 = TensorSpec((T_TOKENS, d), "bfloat16")
    mod16 = pipeline.compile(block16, spec16,
                             options=CompileOptions(target="cuda"))
    mod16_lib = pipeline.compile(block16, spec16,
                                 options=CompileOptions(target="torch"))
    demo_fn, demo_specs, demo_example = pipeline._demo_mlp()
    demo_mod = pipeline.compile(demo_fn, *demo_specs,
                                options=CompileOptions(target="cuda"))
    slice2_demos = {d: pipeline._DEMOS[d]() for d in
                    ("spmv", "paged", "paged_swap")}
    slice2_mods = {d: pipeline.compile(fn, *specs,
                                       options=CompileOptions(target="cuda"))
                   for d, (fn, specs, _) in slice2_demos.items()}

    def bmm(a, b):
        return ops.matmul(a, b)

    bmm_mods = {(sa, sb, dt): pipeline.compile(
        bmm, TensorSpec(sa, dt), TensorSpec(sb, dt),
        options=CompileOptions(target="cuda"))
        for sa, sb in BATCHED_CASES for dt in ("float32", "bfloat16")}
    rn_w = resnet.init_resnet18_weights(np.random.default_rng(0))
    rn_spec = TensorSpec((RESNET_BATCH, 3, RESNET_RES, RESNET_RES),
                         "float32")

    def rn_fn(xv):
        return resnet.resnet18_forward(rn_w, xv)

    rn_mod = pipeline.compile(rn_fn, rn_spec,
                              options=CompileOptions(target="cuda"))
    mala_w = resnet.init_mala_weights(np.random.default_rng(1))
    mala_spec = TensorSpec((MALA_POINTS, 91), "float32")

    def mala_fn(xv):
        return resnet.mala_forward(mala_w, xv)

    mala_mod = pipeline.compile(mala_fn, mala_spec,
                                options=CompileOptions(target="cuda"))
    # phase 17's quickstart port: its bias + gelu region is a library of
    # its own, built with the others
    qs = _import_path(ROOT / "examples" / "quickstart_torch.py",
                      "quickstart_torch")
    qs_mod = pipeline.compile(qs.model, TensorSpec((8, 64), "float32"),
                              options=CompileOptions(target="cuda"))
    # phase 20's lapis-translate graphs: their nests' region libraries are
    # built with the others
    t20_mods = [pipeline.compile(fn, *specs,
                                 options=CompileOptions(target="cuda"))
                for fn, specs, _ in translate_graphs(
                    ops, TensorSpec, np.random.default_rng(20)).values()]

    ragged = (127, 65, 129)
    gemv_mk = (1000, 777)
    sources = (kops.kernel_sources(mod.graph)
               + kops.kernel_sources(mod16.graph)
               + kops.kernel_sources(demo_mod.graph)
               + [mm.matmul_kernel()]
               + [ks for m in slice2_mods.values()
                  for ks in kops.kernel_sources(m.graph)]
               + [spmv_mod.spmv_kernel(), spmm_mod.spmm_kernel(),
                  pk.page_gather_kernel()]
               + kops.serving_kernel_sources()
               + [ks for m in (*bmm_mods.values(), rn_mod, mala_mod,
                               qs_mod, *t20_mods)
                  for ks in kops.kernel_sources(m.graph)])
    t0 = time.perf_counter()
    libs = _build.build_all(sources)
    build_s = time.perf_counter() - t0
    print(f"built {len(set(libs))} kernel libraries with nvcc for sm_90a "
          f"in {build_s:.1f} s", flush=True)
    sass = _build.sass(fa.flash_attention_sm90_kernel())
    n_hgmma, n_tma = sass.count("HGMMA"), sass.count("UTMALDG")
    print(f"flash_attention_sm90.cu SASS: {n_hgmma} HGMMA (wgmma), {n_tma} "
          "UTMALDG (TMA tile loads)", flush=True)
    if not n_hgmma or not n_tma:
        fail("the bf16 flash library issues no wgmma or no TMA load")
    # the redesigned kernels: decode attention's bf16 kernels on the tensor
    # cores (mma.sync) and every K / V ring and small-product ring filled by
    # cp.async (or TMA)
    da_fns = sass_functions(_build.sass(da.decode_attention_kernel()))
    small_fns = {}
    for ks in dict.fromkeys(sources):
        if ks.name == "batched_gemm" and ("LAPIS_SMALL", 1) in ks.defines:
            small_fns.update({f"{n} {ks.defines}": body for n, body in
                              sass_functions(_build.sass(ks)).items()
                              if "lapis_bgemm_small" in n})
    checks = [(n, body, ("HMMA", "LDGSTS") if "decode_attention_bf16_kernel" in n
               else ("LDGSTS",)) for n, body in da_fns.items()
              if "decode_attention_bf16_kernel" in n or "decode_attention_f32_kernel" in n]
    checks += [(n, body, ("LDGSTS",)) for n, body in small_fns.items()]
    if not any("decode_attention_bf16_kernel" in n for n, _, _ in checks) or \
            not small_fns:
        fail("no decode-attention bf16 kernel or no small batched kernel "
             "in the SASS")
    for n, body, need in checks:
        if not all(w in body or (w == "LDGSTS" and "UTMALDG" in body)
                   for w in need):
            fail(f"{n} SASS lacks {need}")
    # the MoE's grouped products: every kernel wgmma fed by TMA, no local
    # memory
    grouped_fns = {n: b for n, b in sass_functions(
        _build.sass(gg.grouped_gemm_kernel())).items()
        if "lapis_grouped_kernel" in n}
    if not grouped_fns or any(
            "HGMMA" not in b or "UTMALDG" not in b or "LDL" in b or "STL" in b
            for b in grouped_fns.values()):
        fail("a grouped expert-product kernel lacks HGMMA or UTMALDG or "
             "spills to local memory")
    print(f"grouped_gemm.cu SASS: {len(grouped_fns)} kernels, each HGMMA + "
          "UTMALDG, no LDL / STL", flush=True)
    # the GEMM: in both libraries every bf16 kernel is wgmma fed by TMA and
    # every f32 FFMA kernel stages by cp.async
    for ks in (mm.matmul_kernel(), bgm.batched_gemm_kernel(False)):
        fns = sass_functions(_build.sass(ks))
        sm90 = {n: b for n, b in fns.items() if "lapis_gemm_sm90" in n}
        f32 = {n: b for n, b in fns.items()
               if "lapis_gemm_ffma_kernelIff" in n}
        if not sm90 or not f32:
            fail(f"{ks.name} SASS has no wgmma kernel or no f32 FFMA kernel")
        for n, body in sm90.items():
            if "HGMMA" not in body or "UTMALDG" not in body:
                fail(f"{ks.name} {n} SASS lacks HGMMA or UTMALDG")
        for n, body in f32.items():
            if "LDGSTS" not in body:
                fail(f"{ks.name} {n} SASS lacks LDGSTS")
        print(f"{ks.name} GEMM SASS: {len(sm90)} wgmma kernels, "
              f"{sum(b.count('HGMMA') for b in sm90.values())} HGMMA, "
              f"{sum(b.count('UTMALDG') for b in sm90.values())} UTMALDG; "
              f"{len(f32)} f32 FFMA kernels, "
              f"{sum(b.count('LDGSTS') for b in f32.values())} LDGSTS",
              flush=True)
    # RMSNorm and the row softmax: every register-path kernel (f32 and
    # bf16, 1..MAX_VPT vectors a thread) loads by 16-byte vectors and
    # touches no local memory
    for ks, sym in ((rn.rmsnorm_kernel(), "lapis_rmsnorm_vec"),
                    (generic.softmax_kernel(), "lapis_softmax_vec")):
        fns = {n: b for n, b in sass_functions(_build.sass(ks)).items()
               if sym in n}
        if len(fns) != 2 * row_reduce.MAX_VPT:
            fail(f"{ks.name} SASS has {len(fns)} {sym} kernels, want "
                 f"{2 * row_reduce.MAX_VPT}")
        for n, body in fns.items():
            if "LDG.E.128" not in body:
                fail(f"{ks.name} {n} SASS has no 16-byte load (LDG.E.128)")
            if re.search(r"\b(?:LDL|STL)\b", body):
                fail(f"{ks.name} {n} SASS touches local memory (LDL/STL)")
        print(f"{ks.name} SASS: {len(fns)} register-path kernels, "
              f"{sum(b.count('LDG.E.128') for b in fns.values())} LDG.E.128 "
              f"(16-byte loads), {sum(b.count('STG.E.128') for b in fns.values())} "
              "STG.E.128, no LDL/STL", flush=True)
    # the RG-LRU scan: no kernel touches local memory; the vector kernels
    # copy x, r, i into their shared ring by 16-byte cp.async
    # (LDGSTS.E.BYPASS.128).  SpMV: every kernel
    # streams its columns and values marked evict-first in L1 (cuobjdump
    # spells ld.global.nc.L1::evict_first LDG.E.EF...; the x gather's L2
    # evict-last policy rides in the memory descriptor), the vector
    # kernels by 16 bytes (LDG.E.EF.128.CONSTANT)
    rg_fns = {n: b for n, b in sass_functions(
        _build.sass(rg.rglru_kernel())).items()
        if "lapis_rglru_kernel" in n}
    rg_vec = {n: b for n, b in rg_fns.items()
              if "__nv_bfloat16Li8E" in n or "IfLi4E" in n}
    if len(rg_fns) != 12 or len(rg_vec) != 4:
        fail(f"rglru.cu SASS has {len(rg_fns)} kernels ({len(rg_vec)} "
             "vector), want 12 (4)")
    for n, body in rg_fns.items():
        if re.search(r"\b(?:LDL|STL)\b", body):
            fail(f"rglru.cu {n} SASS touches local memory (LDL/STL)")
    for n, body in rg_vec.items():
        if "LDGSTS.E.BYPASS.128" not in body:
            fail(f"rglru.cu {n} SASS has no LDGSTS.E.BYPASS.128")
    sp_fns = {n: b for n, b in sass_functions(
        _build.sass(spmv_mod.spmv_kernel())).items()
        if "lapis_spmv_kernel" in n}
    if len(sp_fns) != 24:
        fail(f"spmv.cu SASS has {len(sp_fns)} kernels, want 24")
    for n, body in sp_fns.items():
        if "LDG.E.EF." not in body or ("Li4ELi2EE" in n and
                                       "LDG.E.EF.128.CONSTANT" not in body):
            fail(f"spmv.cu {n} SASS lacks its evict-first stream loads")
    # SpMM: every kernel streams its columns and values evict-first and
    # keeps everything in registers; the vector kernels gather B's rows by
    # 16 bytes
    spmm_fns = {n: b for n, b in sass_functions(
        _build.sass(spmm_mod.spmm_kernel())).items()
        if "lapis_spmm_kernel" in n}
    spmm_vec = {n: b for n, b in spmm_fns.items() if "Li1ELi8EE" not in n}
    if len(spmm_fns) != 24 or len(spmm_vec) != 12:
        fail(f"spmm.cu SASS has {len(spmm_fns)} kernels ({len(spmm_vec)} "
             "vector), want 24 (12)")
    for n, body in spmm_fns.items():
        if "LDG.E.EF." not in body or re.search(r"\b(?:LDL|STL)\b", body):
            fail(f"spmm.cu {n} SASS lacks its evict-first stream loads or "
                 "touches local memory")
    for n, body in spmm_vec.items():
        if "LDG.E.128" not in body:
            fail(f"spmm.cu {n} SASS gathers no 16-byte vector (LDG.E.128)")
    print(f"spmm.cu SASS: {len(spmm_fns)} kernels, no LDL/STL, loads "
          + ", ".join(f"{k} {v}" for k, v in sorted(collections.Counter(
              re.findall(r"LDG\.E[A-Z0-9.]*", "".join(spmm_fns.values())))
              .items())), flush=True)
    print(f"rglru.cu SASS: {len(rg_fns)} kernels, no LDL/STL, "
          f"{sum(b.count('LDGSTS.E.BYPASS.128') for b in rg_vec.values())} "
          "LDGSTS.E.BYPASS.128 (cp.async into the ring); spmv.cu SASS: "
          f"{len(sp_fns)} kernels, loads "
          + ", ".join(f"{k} {v}" for k, v in sorted(collections.Counter(
              re.findall(r"LDG\.E[A-Z0-9.]*", "".join(sp_fns.values())))
              .items())), flush=True)
    # the f32 flash kernels stage Q, K and V by cp.async (LDGSTS); they and
    # every WKV kernel keep everything in registers (no LDL / STL)
    fa32_fns = {n: b for n, b in sass_functions(
        _build.sass(fa.flash_attention_kernel())).items()
        if "lapis_flash_f32_kernel" in n}
    wkv_fns = {n: b for n, b in sass_functions(
        _build.sass(rw.rwkv6_kernel())).items()
        if "lapis_rwkv6_kernel" in n}
    if len(fa32_fns) != 16 or len(wkv_fns) != 24:
        fail(f"flash_attention.cu SASS has {len(fa32_fns)} f32 kernels (want "
             f"16), rwkv6.cu {len(wkv_fns)} (want 24)")
    for n, body in fa32_fns.items():
        if "LDGSTS" not in body:
            fail(f"flash_attention.cu {n} SASS has no LDGSTS")
    for n, body in wkv_fns.items():   # the products on mma.sync (3xTF32)
        if "HMMA" not in body:
            fail(f"rwkv6.cu {n} SASS has no HMMA")
    for n, body in {**fa32_fns, **wkv_fns}.items():
        if re.search(r"\b(?:LDL|STL)\b", body):
            fail(f"{n} SASS touches local memory (LDL/STL)")
    print(f"flash_attention.cu SASS: {len(fa32_fns)} f32 kernels, "
          f"{sum(b.count('LDGSTS') for b in fa32_fns.values())} LDGSTS, no "
          f"LDL/STL; rwkv6.cu SASS: {len(wkv_fns)} kernels, "
          f"{sum(b.count('HMMA') for b in wkv_fns.values())} HMMA, "
          f"{sum(b.count('LDGSTS') for b in wkv_fns.values())} LDGSTS, no "
          "LDL/STL", flush=True)
    print(f"decode_attention.cu SASS: {len(checks) - len(small_fns)} "
          f"kernels, {sum(b.count('HMMA') for b in da_fns.values())} HMMA "
          f"(mma.sync), {sum(b.count('LDGSTS') for b in da_fns.values())} "
          f"LDGSTS (cp.async); small batched_gemm.cu SASS: "
          f"{len(small_fns)} kernels, each with LDGSTS "
          f"({sum(b.count('LDGSTS') for b in small_fns.values())} in all)",
          flush=True)

    # ---------------------------------------------------------------- 2
    worst = {n: 0.0 for n in wrappers}

    def compare(name, got, want, tol, what, relative=False) -> float:
        """Max abs error of a kernel against its plain version: at most
        ``tol`` (f32 at the demo sizes), or ``tol`` × max|plain| where a
        long sum's order moves the last bits (K = 8960)."""
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = float((got.float() - want.float()).abs().max())
        limit = tol * (float(want.float().abs().max()) if relative else 1.0)
        ok = err <= limit and bool(torch.isfinite(got).all())
        print(f"  {what}: max|kernel - plain| = {err:.3e} "
              f"(limit {limit:.3e}) {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"{what} disagrees with its plain version")
        worst[name] = max(worst[name], err)
        return err

    def randn(*shape, scale=1.0):
        return on_card((rng.standard_normal(shape) * scale)
                       .astype(np.float32))

    print("phase 2: kernels vs plain versions on the card", flush=True)
    # every generated region library (one map kernel each) loads by 16
    # bytes and keeps everything in registers
    region_srcs = [ks for ks in dict.fromkeys(sources) if ks.name == "region"]
    for ks in region_srcs:
        fns = sass_functions(_build.sass(ks))
        if len(fns) != 1:
            fail(f"a region library has {len(fns)} kernels, want 1")
        for n, body in fns.items():
            if "LDG.E.128" not in body or re.search(r"\b(?:LDL|STL)\b",
                                                      body):
                fail(f"region kernel {n} SASS: no LDG.E.128, or LDL/STL")
    print(f"region SASS: {len(region_srcs)} generated libraries, each one "
          "map kernel with LDG.E.128 and no LDL/STL", flush=True)
    gemms = [op for op in demo_mod.graph.ops if op.opname == "kk.gemm"]
    for op in gemms:
        (m, k), (_, n) = (o.type.shape for o in op.operands)
        a, b = randn(m, k), randn(k, n, scale=k ** -0.5)
        compare("matmul", mm.matmul(a, b, tiling=op.attrs["tiling"]),
                ref.matmul(a, b), 1e-5, f"matmul mlp {m}x{k}x{n}")
    m, k, n = ragged
    a, b = randn(m, k), randn(k, n, scale=k ** -0.5)
    compare("matmul", mm.matmul(a, b), ref.matmul(a, b), 1e-5,
            f"matmul ragged {m}x{k}x{n}")
    a, v = randn(*gemv_mk), randn(gemv_mk[1], scale=gemv_mk[1] ** -0.5)
    compare("matmul", kops.gemv_cuda(a, v), ref.gemv(a, v), 1e-5,
            f"gemv {gemv_mk[0]}x{gemv_mk[1]}")
    block_gemms = [op for op in mod.graph.ops if op.opname == "kk.gemm"]
    block_ins = {}
    for op in block_gemms:
        (m, k), (_, n) = (o.type.shape for o in op.operands)
        a = randn(m, k)
        b = params["w_down"] if k == d_ff else params["w_gate"]
        block_ins.setdefault((m, k, n), (a, b, op.attrs["tiling"]))
        compare("matmul", mm.matmul(a, b, tiling=op.attrs["tiling"]),
                ref.matmul(a, b), 1e-4, f"matmul block {m}x{k}x{n}",
                relative=True)

    # (op, its module is the block) for every mapped nest on the path
    nests = [(op, m is mod) for m in (demo_mod, mod) for op in m.graph.ops
             if op.opname == "kokkos.team_parallel"]
    # ResNet18's head: the (8, 1000) softmax of phase 13
    nests += [(op, False) for op in rn_mod.graph.ops
              if op.opname == "kokkos.team_parallel"
              and op.attrs["kind"] == "reduce"]
    nest_ins = []     # (kernel name, label, op, inputs, region, on_block)
    for op, on_block in nests:
        shape = op.results[0].type.shape
        block_shape = op.attrs["tiling"]["block"]
        args = [randn(*o.type.shape) for o in op.operands]
        label = (" -> ".join(op.attrs.get("ops", (op.attrs["src"],)))
                 + f" {'x'.join(map(str, shape))}")
        if op.attrs["kind"] == "reduce":
            compare("row_softmax",
                    generic.row_softmax(args[0], block=block_shape),
                    refs.softmax(args[0], -1), 1e-5, f"row_softmax {label}")
            nest_ins.append(("row_softmax", label, op, args, None, on_block))
        else:
            region = op.regions[0] if op.regions else \
                generic.one_op_region(op)
            mp = map_plan(region, args, shape)
            label += (f" (plan {mp['vec']} a vector x {mp['unroll']}, "
                      f"{mp['grid']} x {mp['threads']}, tail {mp['tail']})")
            got = generic.block_map_region(region, args, shape, "float32",
                                           block=block_shape)
            compare("block_map_region", got, refs.region_ref(region)(*args),
                    1e-5, f"block_map_region {label}")
            nest_ins.append(("block_map_region", label, op, args, region,
                             on_block))

    print("phase 2b: sparse and paged kernels vs plain versions", flush=True)
    for label, dense in small_matrices(np, rng).items():
        nz_r, nz_c = np.nonzero(dense)
        indptr = np.zeros(dense.shape[0] + 1, np.int32)
        np.cumsum(np.count_nonzero(dense, axis=1), out=indptr[1:])
        a = spmv_mod.CsrMatrix(on_card(indptr), on_card(nz_c.astype(np.int32)),
                               on_card(dense[nz_r, nz_c].astype(np.float32)),
                               *dense.shape)
        xv, bm = randn(dense.shape[1]), randn(dense.shape[1], SPMM_COLS)
        a64 = a._replace(values=a.values.double())
        compare("spmv", spmv_mod.spmv(a, xv),
                spmv_mod.spmv_reference(a64, xv.double()).float(), 1e-5,
                f"spmv {label}")
        compare("spmm", spmm_mod.spmm_sparse(a, bm),
                spmv_mod.spmm_reference(a64, bm.double()).float(), 1e-5,
                f"spmm {label} x {SPMM_COLS}")
    (demo_spmv,) = [op for op in slice2_mods["spmv"].graph.ops
                    if op.opname == "kk.spmv"]
    ip, ind, val, xv = (on_card(t) for t in slice2_demos["spmv"][2])
    a = spmv_mod.CsrMatrix(ip, ind, val, xv.shape[0], xv.shape[0])
    compare("spmv", spmv_mod.spmv(a, xv, tiling=demo_spmv.attrs["tiling"]),
            spmv_mod.spmv_reference(a, xv), 1e-5,
            f"spmv demo 512x512 tiling {demo_spmv.attrs['tiling']}")
    pool, table, lengths, _ = (on_card(t) for t in slice2_demos["paged"][2])
    compare("page_gather", pk.page_gather(pool, table, lengths, block_size=8),
            pk.page_gather_torch(pool, table, lengths, block_size=8), 0.0,
            f"page_gather demo pool {tuple(pool.shape)} table "
            f"{tuple(table.shape)}")

    # ---------------------------------------------------------------- 3
    print("phase 3: --demo mlp --target cuda", flush=True)
    demo_launches = demo_mod.launch_count
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pipeline.main(["--demo", "mlp", "--target", "cuda"])
    torch.cuda.synchronize()
    demo_counts = counts()
    out = buf.getvalue().strip()
    print(f"  {out}", flush=True)
    if rc != 0:
        fail(f"pipeline.main returned {rc}")
    try:
        total = float(out.rsplit("sum:", 1)[1])
    except (IndexError, ValueError):
        fail(f"unexpected demo output {out!r}")
    if "output shape: (8, 10)" not in out or abs(total - 8.0) > 1e-4:
        fail(f"demo output {out!r}, want shape (8, 10) and sum 8.0")
    k2 = demo_counts["block_map_region"][0] + demo_counts["row_softmax"][0]
    plain = sum(c[1] for c in demo_counts.values())
    print(f"  launch_count {demo_launches}; launches {demo_counts}",
          flush=True)
    if demo_launches != 4 or demo_counts["matmul"][0] != 2 or k2 != 2 \
            or plain != 0:
        fail("demo did not run as 4 launches (2 matmul + 2 block_map) "
             "with no plain-version call")

    path_counts["demo mlp"] = demo_counts
    want_launches = {"spmv": {"spmv": 1, "block_map_region": 1},
                     "paged": {"page_gather": 1}, "paged_swap": {}}
    for demo, (fn, specs, example) in slice2_demos.items():
        print(f"phase 3: --demo {demo} --target cuda", flush=True)
        reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = pipeline.main(["--demo", demo, "--target", "cuda"])
        torch.cuda.synchronize()
        c = path_counts[f"demo {demo}"] = counts()
        out = buf.getvalue().strip()
        launched = {n: l for n, (l, _) in c.items() if l}
        print(f"  {out}; launches {launched}", flush=True)
        if rc != 0:
            fail(f"pipeline.main --demo {demo} returned {rc}")
        if launched != want_launches[demo] or any(p for _, p in c.values()):
            fail(f"demo {demo} launched {launched}, want "
                 f"{want_launches[demo]}, with no plain-version call")
        y_cuda = slice2_mods[demo](*example)
        y_lib = pipeline.compile(fn, *specs, options=CompileOptions(
            target="torch"))(*example)
        torch.cuda.synchronize()
        err = float((y_cuda - y_lib).abs().max())
        limit = 1e-5 if demo == "spmv" else 0.0    # the paged ops are copies
        print(f"  cuda vs torch target: max abs err {err:.3e} (limit "
              f"{limit:.0e})", flush=True)
        if err > limit or f"output shape: {tuple(y_lib.shape)}" not in out:
            fail(f"demo {demo} disagrees with the torch target")

    # ---------------------------------------------------------------- 4
    print(f"phase 4: qwen2-1.5b gated MLP block, T={T_TOKENS}, f32",
          flush=True)
    reset_counts()
    y = mod(x)
    torch.cuda.synchronize()
    block_counts = path_counts["qwen2 block"] = counts()
    print(f"  launch_count {mod.launch_count}; launches {block_counts}",
          flush=True)
    if mod.launch_count != 5 or block_counts["matmul"] != (3, 0) or \
            block_counts["block_map_region"] != (2, 0) or \
            block_counts["row_softmax"][1] != 0:
        fail("block did not run as 5 launches (3 matmul + 2 block_map) "
             "with no plain-version call")
    w = params
    want = torch.matmul(torch.nn.functional.silu(x @ w["w_gate"])
                        * (x @ w["w_up"]), w["w_down"]) + x
    err = float((y - want).abs().max())
    limit = 1e-4 * float(want.abs().max())
    print(f"  block vs plain torch block: max abs err {err:.3e} "
          f"(limit {limit:.3e})", flush=True)
    if not (err <= limit and bool(torch.isfinite(y).all())
            and tuple(y.shape) == (T_TOKENS, d)):
        fail("the compiled block disagrees with the plain block")
    y_lib = mod_lib(x)
    torch.cuda.synchronize()
    err_lib = float((y_lib - want).abs().max())
    print(f"  library-compiled block vs plain block: {err_lib:.3e}",
          flush=True)
    block_ms = time_ms(lambda: mod(x), with_host=True)
    block_lib_ms = time_ms(lambda: mod_lib(x), with_host=True)
    block_dev_ms = time_ms(lambda: mod(x))
    block_lib_dev_ms = time_ms(lambda: mod_lib(x))
    gemm_flops = sum(2.0 * m * k * n for (m, k), (_, n) in
                     ((o.operands[0].type.shape, o.operands[1].type.shape)
                      for o in block_gemms))
    print(f"  block call: cuda target {block_ms:.4f} ms, torch target "
          f"(library_ms) {block_lib_ms:.4f} ms; device time alone "
          f"{block_dev_ms:.4f} / {block_lib_dev_ms:.4f} ms; the 3 gemms are "
          f"{gemm_flops / 1e9:.1f} GFLOP", flush=True)

    # the same block in bf16: its gemms on the wgmma route
    print(f"phase 4: the same block in bf16 (T={T_TOKENS})", flush=True)
    x16 = x.bfloat16()
    reset_counts()
    y16 = mod16(x16)
    torch.cuda.synchronize()
    c16 = path_counts["qwen2 block bf16"] = counts()
    print(f"  launch_count {mod16.launch_count}; launches "
          f"{ {n: l for n, (l, _) in c16.items() if l} }", flush=True)
    if mod16.launch_count != 5 or c16["matmul_bf16"] != (3, 0) or \
            c16["matmul"][0] != 0 or c16["block_map_region"] != (2, 0):
        fail("the bf16 block did not run as 3 wgmma gemms + 2 block_map "
             "with no plain-version call")
    want16 = mod16_lib(x16)
    torch.cuda.synchronize()
    err16 = float((y16.float() - want16.float()).abs().max())
    lim16 = 2e-2 * float(want16.float().abs().max())
    print(f"  bf16 block vs the torch target's: max abs err {err16:.3e} "
          f"(limit {lim16:.3e}, 2e-2 of max|y|)", flush=True)
    if not (err16 <= lim16 and bool(torch.isfinite(y16).all())
            and tuple(y16.shape) == (T_TOKENS, d)):
        fail("the bf16 block disagrees with the torch target")
    block16_dev_ms = time_ms(lambda: mod16(x16))
    block16_lib_dev_ms = time_ms(lambda: mod16_lib(x16))
    print(f"  bf16 block device time: cuda target {block16_dev_ms:.4f} ms, "
          f"torch target {block16_lib_dev_ms:.4f} ms", flush=True)

    # per-kernel times at the main path's shapes
    rows = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "ops": 0.0, "bytes": 0.0, "peak": PEAK_FP32_PER_S}
            for n in wrappers}

    def add_row(name, t_k, t_p, t_l, ops_n, bytes_n) -> None:
        r = rows[name]
        r["ms"] += t_k
        r["plain_ms"] += t_p
        r["library_ms"] += t_l
        r["ops"] += ops_n
        r["bytes"] += bytes_n
    rows["matmul_bf16"]["peak"] = PEAK_BF16_PER_S
    rows["batched_gemm_tiled_bf16"]["peak"] = PEAK_BF16_PER_S
    gemm_stats = []
    for op in block_gemms:
        (m, k), (_, n) = (o.type.shape for o in op.operands)
        a, b, tiling = block_ins[(m, k, n)]
        for name, dt in (("matmul", torch.float32),
                         ("matmul_bf16", torch.bfloat16)):
            a_, b_ = a.to(dt), b.to(dt)
            plan = mm.plan_for(a_, b_)
            if plan["route"] != ("ffma" if dt == torch.float32 else "wgmma"):
                fail(f"matmul {m}x{k}x{n} {dt} planned {plan['route']}")
            if dt == torch.bfloat16:
                compare(name, mm.matmul(a_, b_, tiling=tiling),
                        ref.matmul(a_, b_), 2e-2,
                        f"matmul_bf16 block {m}x{k}x{n}", relative=True)
            t_k = time_ms(lambda: mm.matmul(a_, b_, tiling=tiling))
            t_p = time_ms(lambda: ref.matmul(a_, b_))
            t_l = time_ms(lambda: torch.matmul(a_, b_))
            item = a_.element_size()
            ops_n = 2.0 * m * k * n
            bytes_n = item * (m * k + k * n + m * n)
            b_ms, b_by = bound(bytes_n, ops_n, rows[name]["peak"])
            print(f"  {name} {m}x{k}x{n} (IR tiling {tiling}; "
                  f"{plan_line(plan)}): {t_k:.4f} ms (plain {t_p:.4f}, "
                  f"torch.matmul {t_l:.4f}, bound {b_ms:.4f} by {b_by}; "
                  f"{ops_n / t_k / 1e9:.1f} TFLOP/s)", flush=True)
            add_row(name, t_k, t_p, t_l, ops_n, bytes_n)
            gemm_stats.append({"m": m, "k": k, "n": n, "dtype": str(dt),
                               "route": plan["route"], "ms": t_k,
                               "plain_ms": t_p, "library_ms": t_l,
                               "bound_ms": b_ms})
    softmax_stats, nest_stats = [], []
    for name, label, op, args, region, on_block in nest_ins:
        shape = op.results[0].type.shape
        n_el = float(np.prod(shape))
        if name == "row_softmax":
            block_shape = op.attrs["tiling"]["block"]
            sp = row_plan("softmax", int(n_el) // shape[-1], shape[-1],
                          torch.float32)
            label += f" ({row_plan_line(sp)})"
            t_k = time_ms(lambda: generic.row_softmax(args[0],
                                                      block=block_shape))
            t_p = time_ms(lambda: refs.softmax(args[0], -1))
            t_l = time_ms(lambda: torch.softmax(args[0], -1))
            ops_n = 4.0 * n_el          # max, sub+exp, sum, scale
        else:
            block_shape = op.attrs["tiling"]["block"]
            body = refs.region_ref(region)
            t_k = time_ms(lambda: generic.block_map_region(
                region, args, shape, "float32", block=block_shape))
            t_p = time_ms(lambda: body(*args))
            if len(region.ops) == 1 and region.ops[0].opname == "linalg.add":
                t_l = time_ms(lambda: torch.add(*args))
            else:
                t_l = None     # no single torch call computes the chain
            ops_n = n_el * sum(4.0 if s.opname in ("linalg.silu",
                                                   "linalg.sigmoid")
                               else 1.0 for s in region.ops)
        bytes_n = 4.0 * n_el * (len(args) + 1)
        b_ms, b_by = bound(bytes_n, ops_n)
        print(f"  {name} {label}: {t_k:.4f} ms (plain {t_p:.4f}, library "
              f"{'n/a' if t_l is None else f'{t_l:.4f}'}, bound "
              f"{b_ms:.6f} by {b_by})", flush=True)
        r = rows[name]
        # the block's nests are the main path's at full width; the demo's
        # and ResNet18's row softmaxes are the softmaxes on the paths
        if name == "row_softmax":
            softmax_stats.append({"shape": list(shape), "plan": sp,
                                  "ms": t_k, "plain_ms": t_p,
                                  "library_ms": t_l, "bound_ms": b_ms})
        else:
            nest_stats.append({"nest": label, "dtype": "float32",
                               "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                               "bound_ms": b_ms})
        if on_block or name == "row_softmax":
            r["ms"] += t_k
            r["plain_ms"] += t_p
            r["library_ms"] = (None if (t_l is None or
                                        r["library_ms"] is None)
                               else r["library_ms"] + t_l)
            r["ops"] += ops_n
            r["bytes"] += bytes_n
    # the bf16 block's two nests (silu.mul, the residual add): held to the
    # plain version in f32 within 2^-8 of the row's largest value (f32
    # inside, one rounding), timed beside it and torch.add
    for op in mod16.graph.ops:
        if op.opname != "kokkos.team_parallel" or op.attrs["kind"] != "map":
            continue
        shape = op.results[0].type.shape
        n_el = float(np.prod(shape))
        region = op.regions[0] if op.regions else generic.one_op_region(op)
        args = [randn(*o.type.shape).bfloat16() for o in op.operands]
        block_shape = op.attrs["tiling"]["block"]
        mp = map_plan(region, args, shape)
        got = generic.block_map_region(region, args, shape, "bfloat16",
                                       block=block_shape)
        want = refs.region_ref(region)(*[a.float() for a in args])
        torch.cuda.synchronize()
        err = float(((got.float() - want).abs()
                     - 2.0 ** -8 * want.abs().amax(-1, keepdim=True)).max())
        label = (" -> ".join(op.attrs.get("ops", (op.attrs["src"],)))
                 + f" {'x'.join(map(str, shape))} bf16")
        if err > 0 or not bool(torch.isfinite(got).all()):
            fail(f"block_map_region {label} exceeds 2^-8 of its row's "
                 f"largest value by {err:.3e}")
        worst["block_map_region"] = max(
            worst["block_map_region"],
            float((got.float() - want.to(torch.bfloat16).float()).abs().max()))
        t_k = time_ms(lambda: generic.block_map_region(
            region, args, shape, "bfloat16", block=block_shape))
        t_p = time_ms(lambda: refs.region_ref(region)(*args))
        t_l = (time_ms(lambda: torch.add(*args))
               if [s_.opname for s_ in region.ops] == ["linalg.add"]
               else None)
        b_ms, b_by = bound(2.0 * n_el * (len(args) + 1), n_el)
        print(f"  block_map_region {label} (plan {mp['vec']} a vector x "
              f"{mp['unroll']}, {mp['grid']} x {mp['threads']}): {t_k:.4f} "
              f"ms (plain {t_p:.4f}, library "
              f"{'n/a' if t_l is None else f'{t_l:.4f}'}, bound {b_ms:.6f} "
              f"by {b_by}); within 2^-8 of the row's largest value",
              flush=True)
        nest_stats.append({"nest": label, "dtype": "bfloat16", "ms": t_k,
                           "plain_ms": t_p, "library_ms": t_l,
                           "bound_ms": b_ms})

    # ---------------------------------------------------------------- 5
    print("phase 5: SpMV at Table 6.1 sizes (synthetic CSR, full rows)",
          flush=True)
    gen = torch.Generator(device=dev)
    spmv_stats = []
    for i, (name, n, mean, mx) in enumerate(TABLE_6_1):
        gen.manual_seed(i)
        ip, cols, vals = synth_csr(torch, n, mean, mx, gen)
        nnz = int(vals.shape[0])
        max_row = int((ip[1:] - ip[:-1]).max())
        xv = torch.randn(n, generator=gen, device=dev)

        def spmv_fn(ipv, indv, valv, x_, _n=n, _m=max_row):
            return ops.spmv_csr(ipv, indv, valv, x_, n_rows=_n,
                                max_nnz_row=_m)

        smod = pipeline.compile(spmv_fn, ip, cols, vals, xv,
                                options=CompileOptions(target="cuda"))
        (op,) = [o for o in smod.graph.ops if o.opname == "kk.spmv"]
        tiling = op.attrs["tiling"]
        reset_counts()
        y = smod(ip, cols, vals, xv)
        torch.cuda.synchronize()
        c = path_counts[f"spmv {name}"] = counts()
        launched = {k: l for k, (l, _) in c.items() if l}
        if launched != {"spmv": 1} or any(p for _, p in c.values()):
            fail(f"spmv {name} launched {launched} with plain calls")
        a = spmv_mod.CsrMatrix(ip, cols, vals, n, n)
        compare("spmv", y, spmv_mod.spmv_reference(a, xv), 1e-4,
                f"spmv {name} ({n} rows, nnz {nnz}, max/row {max_row})",
                relative=True)
        with warnings.catch_warnings():    # "beta" and invariant notes
            warnings.simplefilter("ignore", UserWarning)
            lib_a = torch.sparse_csr_tensor(ip, cols, vals, size=(n, n))
        lib_err = float((torch.mv(lib_a, xv) - y).abs().max())
        t_k = time_ms(lambda: spmv_mod.spmv(a, xv, tiling=tiling))
        t_call = time_ms(lambda: smod(ip, cols, vals, xv), with_host=True)
        t_p = time_ms(lambda: spmv_mod.spmv_reference(a, xv))
        t_l = time_ms(lambda: torch.mv(lib_a, xv))
        # the practical ceiling: the x gather alone, on the same columns
        t_g = time_ms(lambda: xv.index_select(0, cols))
        bytes_n = 8.0 * nnz + 8.0 * n + 4.0 * (n + 1)
        b_ms, b_by = bound(bytes_n, 2.0 * nnz)
        plan = spmv_plan(n, tiling)
        print(f"  spmv {name} tiling {tiling} (plan {plan['lanes']} lanes x "
              f"{plan['vec']} entries, unroll {plan['unroll']}, "
              f"{plan['threads']} threads, grid {plan['grid']}): kernel "
              f"{t_k:.4f} ms, call {t_call:.4f} ms (host incl.), plain "
              f"{t_p:.4f}, cuSPARSE {t_l:.4f} (vs kernel {lib_err:.1e}), "
              f"gather alone (index_select) {t_g:.4f}, bound {b_ms:.4f} by "
              f"{b_by} ({bytes_n / t_k / 1e6:.0f} GB/s)", flush=True)
        add_row("spmv", t_k, t_p, t_l, 2.0 * nnz, bytes_n)
        spmv_stats.append({"matrix": name, "rows": n, "nnz": nnz,
                           "max_nnz_row": max_row, "tiling": tiling,
                           "plan": plan, "kernel_ms": t_k, "call_ms": t_call,
                           "plain_ms": t_p, "cusparse_ms": t_l,
                           "gather_ms": t_g, "bound_ms": b_ms})
        if name == SPMM_MATRIX:
            spmm_in = (n, nnz, max_row, ip, cols, vals, a, lib_a)
        del ip, cols, vals, xv, y, a, lib_a

    n, nnz, max_row, ip, cols, vals, a, lib_a = spmm_in
    del spmm_in
    print(f"phase 5: SpMM {SPMM_MATRIX} x {SPMM_COLS} columns", flush=True)
    bv = torch.randn((n, SPMM_COLS), generator=gen, device=dev)

    def spmm_fn(ipv, indv, valv, b_, _n=n, _m=max_row):
        return ops.spmm_csr(ipv, indv, valv, b_, n_rows=_n,
                            max_nnz_row=_m)

    mmod = pipeline.compile(spmm_fn, ip, cols, vals, bv,
                            options=CompileOptions(target="cuda"))
    (op,) = [o for o in mmod.graph.ops if o.opname == "kk.spmm"]
    tiling = op.attrs["tiling"]
    reset_counts()
    yb = mmod(ip, cols, vals, bv)
    torch.cuda.synchronize()
    c = path_counts[f"spmm {SPMM_MATRIX}"] = counts()
    launched = {k: l for k, (l, _) in c.items() if l}
    if launched != {"spmm": 1} or any(p for _, p in c.values()):
        fail(f"spmm launched {launched} with plain calls")
    compare("spmm", yb, spmv_mod.spmm_reference(a, bv), 1e-4,
            f"spmm {SPMM_MATRIX} x {SPMM_COLS}", relative=True)
    t_k = time_ms(lambda: spmm_mod.spmm_sparse(a, bv, tiling=tiling))
    t_call = time_ms(lambda: mmod(ip, cols, vals, bv), with_host=True)
    t_p = time_ms(lambda: spmv_mod.spmm_reference(a, bv))
    t_l = time_ms(lambda: torch.sparse.mm(lib_a, bv))
    # the same CSR product as one embedding_bag (a yardstick, never called
    # by the port): B's rows by column index, weighted by the values,
    # summed over each row's offsets
    def bag():
        return torch.nn.functional.embedding_bag(
            cols, bv, ip, mode="sum", per_sample_weights=vals,
            include_last_offset=True)
    y_bag = bag()
    bag_err = float((yb - y_bag).abs().max()) / float(y_bag.abs().max())
    if not bag_err <= 1e-4:
        fail(f"spmm and F.embedding_bag differ by {bag_err:.3e} of max|Y|")
    del y_bag
    t_bag = time_ms(bag)
    two = spmm_mod.spmm_sparse(a, bv, tiling=tiling)
    if not torch.equal(two, spmm_mod.spmm_sparse(a, bv, tiling=tiling)):
        fail("spmm: two calls differ in their bits")
    del two
    ops_n = 2.0 * nnz * SPMM_COLS
    bytes_n = 8.0 * nnz + 4.0 * (n + 1) + 8.0 * n * SPMM_COLS
    b_ms, b_by = bound(bytes_n, ops_n)
    mplan = spmm_plan(n, SPMM_COLS, tiling, 4)
    print(f"  spmm tiling {tiling} (plan {mplan['lanes']} lanes x "
          f"{mplan['vec']} columns, {mplan['groups']} groups, unroll "
          f"{mplan['unroll']}, {mplan['threads']} threads, grid "
          f"{mplan['grid_rows']} x {mplan['grid_cols']}): kernel {t_k:.4f} "
          f"ms, call {t_call:.4f} ms, plain {t_p:.4f}, torch.sparse.mm "
          f"{t_l:.4f}, F.embedding_bag {t_bag:.4f}, bound {b_ms:.4f} by "
          f"{b_by}; two calls bitwise equal; vs F.embedding_bag "
          f"{bag_err:.1e} of max|Y|", flush=True)
    add_row("spmm", t_k, t_p, t_l, ops_n, bytes_n)
    spmm_stats = {"matrix": SPMM_MATRIX, "cols": SPMM_COLS, "tiling": tiling,
                  "plan": mplan, "kernel_ms": t_k, "call_ms": t_call,
                  "plain_ms": t_p, "library_ms": t_l,
                  "embedding_bag_ms": t_bag, "bound_ms": b_ms}
    del bv, yb, ip, cols, vals, a, lib_a
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 6
    pages = POSITIONS // BLOCK
    print(f"phase 6: paged step, {SLOTS} slots x {POSITIONS} positions, "
          f"{KV_HEADS} KV heads x {HEAD_DIM}, block {BLOCK}, f32",
          flush=True)
    gen.manual_seed(100)
    pool = torch.randn((SLOTS * pages + 1, KV_HEADS, BLOCK, HEAD_DIM),
                       generator=gen, device=dev)
    table = (torch.randperm(SLOTS * pages, generator=gen, device=dev) + 1) \
        .to(torch.int32).view(SLOTS, pages)
    lengths = torch.randint(0, POSITIONS, (SLOTS,), generator=gen,
                            device=dev, dtype=torch.int32)
    kv = torch.randn((SLOTS, KV_HEADS, HEAD_DIM), generator=gen, device=dev)

    def paged_step(p_, t_, l_, k_):
        p2 = ops.page_append(p_, t_, l_, k_, block_size=BLOCK)
        return ops.page_gather(p2, t_, l_, block_size=BLOCK)

    pmod = pipeline.compile(paged_step, pool, table, lengths, kv,
                            options=CompileOptions(target="cuda"))
    pmod_lib = pipeline.compile(paged_step, pool, table, lengths, kv,
                                options=CompileOptions(target="torch"))
    reset_counts()
    view = pmod(pool, table, lengths, kv)
    torch.cuda.synchronize()
    c = path_counts["paged step"] = counts()
    launched = {k: l for k, (l, _) in c.items() if l}
    if launched != {"page_gather": 1} or any(p for _, p in c.values()):
        fail(f"paged step launched {launched} with plain calls")
    compare("page_gather", view, pmod_lib(pool, table, lengths, kv), 0.0,
            f"paged step {tuple(view.shape)} vs the torch target")
    pool2 = pk.page_append_torch(pool, table, lengths, kv, block_size=BLOCK)
    compare("page_gather",
            pk.page_gather(pool2, table, lengths, block_size=BLOCK),
            pk.page_gather_torch(pool2, table, lengths, block_size=BLOCK),
            0.0, f"page_gather full width pool {tuple(pool2.shape)}")
    t_k = time_ms(lambda: pk.page_gather(pool2, table, lengths,
                                         block_size=BLOCK))
    t_p = time_ms(lambda: pk.page_gather_torch(pool2, table, lengths,
                                               block_size=BLOCK))
    t_l = time_ms(lambda: pool2.index_select(0, table.view(-1)).view(
        SLOTS, pages, KV_HEADS, BLOCK, HEAD_DIM).transpose(1, 2).reshape(
        SLOTS, KV_HEADS, POSITIONS, HEAD_DIM))
    t_step = time_ms(lambda: pmod(pool, table, lengths, kv), with_host=True)
    t_step_lib = time_ms(lambda: pmod_lib(pool, table, lengths, kv),
                         with_host=True)
    bytes_n = 2.0 * view.numel() * view.element_size()
    b_ms, b_by = bound(bytes_n, 0.0)
    print(f"  page_gather: kernel {t_k:.4f} ms ({bytes_n / t_k / 1e6:.0f} "
          f"GB/s), plain {t_p:.4f}, index_select+permute {t_l:.4f}, bound "
          f"{b_ms:.4f} by {b_by}; step call {t_step:.4f} ms on cuda, "
          f"{t_step_lib:.4f} on torch", flush=True)
    add_row("page_gather", t_k, t_p, t_l, 0.0, bytes_n)
    paged_stats = {"slots": SLOTS, "positions": POSITIONS,
                   "pool_mb": pool.numel() * 4 / 1e6, "gather_ms": t_k,
                   "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
                   "step_ms": t_step, "step_library_ms": t_step_lib}
    del pool, pool2, view, table, lengths, kv

    # ---------------------------------------------------------------- 7
    print("phase 7: RMSNorm, decode attention and flash attention vs "
          "plain versions on the card", flush=True)
    F = torch.nn.functional
    gen.manual_seed(7)
    heads, kv_heads, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_dec = 2048

    def rand_t(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def decode_f64_gate(q, kc, vc, lens, what) -> tuple:
        """The bf16 kernel's mean |error| against an f64 evaluation, at
        most twice the plain version's (rows with a valid position)."""
        b_, hq_, d_ = q.shape
        hkv_, s_ = kc.shape[1], kc.shape[2]
        pos = torch.arange(s_, device=dev)
        logits = torch.einsum("bhgd,bhsd->bhgs",
                              q.double().view(b_, hkv_, hq_ // hkv_, d_),
                              kc.double()) * d_ ** -0.5
        logits = logits.masked_fill(~(pos < lens[:, None, None, None]),
                                    float("-inf"))
        exact = torch.einsum("bhgs,bhsd->bhgd", torch.softmax(logits, -1),
                             vc.double()).reshape(b_, hq_, d_)
        keep = lens > 0
        got = da.decode_attention(q, kc, vc, lens)
        plain = ref.decode_attention(q, kc, vc, lens)
        err_k = float((got.double() - exact)[keep].abs().mean())
        err_p = float((plain.double() - exact)[keep].abs().mean())
        ok = err_k <= 2.0 * err_p
        print(f"  decode_attention {what} bf16 mean |error| vs f64: kernel "
              f"{err_k:.3e}, plain {err_p:.3e} (limit 2x) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"decode_attention {what}: bf16 kernel error {err_k:.3e} "
                 f"over twice the plain version's {err_p:.3e}")
        return err_k, err_p

    # ragged decode lengths, 0, 1 and S among them
    dec_len = torch.tensor([0, 1, s_dec, 17, 1000, 2047, 513, 64],
                           dtype=torch.int32, device=dev)
    flash_sweep = [  # tests/test_kernels.py: (hq, hkv, sq, skv, causal,
        # window, d, softcap), batch 2
        (4, 4, 64, 64, True, None, 32, None),
        (4, 2, 100, 100, True, None, 32, None),
        (8, 1, 64, 64, True, 17, 32, None),
        (4, 4, 32, 96, False, None, 32, None),
        (6, 2, 65, 65, True, 33, 32, None),
        (2, 2, 48, 48, True, None, 16, 30.0)]
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        # f32: another summation order; bf16: both round an f32 result
        # once, so they differ by an ulp or two of the bf16 output
        tol_rms = 2e-5 if dtype == torch.float32 else 1e-2
        tol_att = 2e-4 if dtype == torch.float32 else 2e-2
        for n_rows, width, _ in RMS_SHAPES:
            xr, wr = rand_t((n_rows, width), dtype), rand_t((width,), dtype)
            compare("rmsnorm", rn.rmsnorm(xr, wr), ref.rmsnorm(xr, wr),
                    tol_rms, f"rmsnorm {n_rows}x{width} {tag} (x max|plain|)",
                    relative=True)
        q = rand_t((SERVE_SLOTS, heads, hd), dtype)
        kc = rand_t((SERVE_SLOTS, kv_heads, s_dec, hd), dtype)
        vc = rand_t((SERVE_SLOTS, kv_heads, s_dec, hd), dtype)
        got = da.decode_attention(q, kc, vc, dec_len)
        want = ref.decode_attention(q, kc, vc, dec_len)
        torch.cuda.synchronize()
        if not (bool(got[0].eq(0).all()) and bool(want[0].isnan().all())):
            fail("decode attention's length-0 row: kernel must give 0, "
                 "the plain version NaN")
        compare("decode_attention", got[1:], want[1:], tol_att,
                f"decode_attention {SERVE_SLOTS}x{heads}/{kv_heads}x{hd} "
                f"S={s_dec} lengths {dec_len.tolist()} {tag} (row 0: 0 "
                "against NaN)")
        win_len = dec_len.clamp(min=1)
        compare("decode_attention",
                da.decode_attention(q, kc, vc, win_len, window=256),
                ref.decode_attention(q, kc, vc, win_len, window=256),
                tol_att, f"decode_attention window 256 {tag}")
        # grok-1's logit cap at its decode heads (48 / 8 x 128), the
        # queries times 10 so that the scores reach the cap of 30 too;
        # 2 rows split the positions, 264 rows do not.  Its own
        # generator: the checks after it see the inputs they always had
        gen_cap = torch.Generator(device=dev)
        gen_cap.manual_seed(30)
        for g_rows, cap in ((2, 30.0), (2, 0.5), (264, 30.0)):
            q_g, k_g, v_g = (
                (torch.randn(shape, generator=gen_cap, device=dev) * sc)
                .to(dtype) for shape, sc in (
                    ((g_rows, 48, 128), 10.0), ((g_rows, 8, 1152, 128), 1.0),
                    ((g_rows, 8, 1152, 128), 1.0)))
            g_len = torch.randint(1, 1153, (g_rows,), generator=gen_cap,
                                  device=dev, dtype=torch.int32)
            compare("decode_attention",
                    da.decode_attention(q_g, k_g, v_g, g_len,
                                        logit_softcap=cap),
                    ref.decode_attention(q_g, k_g, v_g, g_len,
                                         logit_softcap=cap),
                    tol_att, f"decode_attention cap {cap} {g_rows}x48/8x128 "
                    f"S=1152 {tag}")
        del q_g, k_g, v_g
        c_rows = 128
        q_c = rand_t((c_rows, heads, hd), dtype)
        k1, v1 = kc[:1], vc[:1]
        kb = k1.expand(c_rows, kv_heads, s_dec, hd)
        vb = v1.expand(c_rows, kv_heads, s_dec, hd)
        chunk_len = torch.arange(s_dec - c_rows + 1, s_dec + 1,
                                 dtype=torch.int32, device=dev)
        compare("decode_attention",
                da.decode_attention(q_c, kb, vb, chunk_len),
                ref.decode_attention(q_c, kb.contiguous(), vb.contiguous(),
                                     chunk_len),
                tol_att, f"decode_attention stride-0 batch, {c_rows} rows "
                f"of one cached row {tag}")
        qf = rand_t((1, heads, s_dec, hd), dtype)
        kf = rand_t((1, kv_heads, s_dec, hd), dtype)
        vf = rand_t((1, kv_heads, s_dec, hd), dtype)
        fa_row = "flash_attention" if dtype == torch.bfloat16 \
            else "flash_attention_f32"
        compare(fa_row, fa.flash_attention(qf, kf, vf),
                ref.attention(qf, kf, vf), tol_att,
                f"flash_attention 1x{heads}/{kv_heads}x{s_dec}x{hd} causal "
                f"{tag}")
        for hq_, hkv_, sq_, skv_, causal, window, d_, cap in flash_sweep:
            qs = rand_t((2, hq_, sq_, d_), dtype)
            ks = rand_t((2, hkv_, skv_, d_), dtype)
            vs = rand_t((2, hkv_, skv_, d_), dtype)
            kw = {"causal": causal, "window": window, "logit_softcap": cap}
            compare(fa_row, fa.flash_attention(qs, ks, vs, **kw),
                    ref.attention(qs, ks, vs, **kw), tol_att,
                    f"flash_attention {hq_}/{hkv_} heads {sq_}x{skv_}x{d_} "
                    f"{kw} {tag}")

    # times in bf16, the serving dtype, at the phase's headline shapes: the
    # three decode steps' rows and qwen2-1.5b's 2048-token prefill; the
    # kernels line's row sums qwen2-1.5b's two (the shapes of earlier runs)
    bf = torch.bfloat16
    rms_stats = {}
    for n_rows, width, what in RMS_SHAPES:
        xr, wr = rand_t((n_rows, width), bf), rand_t((width,), bf)
        plan = row_plan("rmsnorm", n_rows, width, bf)
        t_k = time_ms(lambda: rn.rmsnorm(xr, wr))
        t_p = time_ms(lambda: ref.rmsnorm(xr, wr))
        t_l = time_ms(lambda: F.rms_norm(xr, (width,), wr, eps=1e-6))
        bytes_n, ops_n = 2.0 * (2 * xr.numel() + width), 4.0 * xr.numel()
        b_ms, b_by = bound(bytes_n, ops_n, PEAK_BF16_PER_S)
        # the bf16 kernel's mean |error| against an f64 evaluation, no
        # larger than the plain version's
        x64, w64 = xr.double(), wr.double()
        exact = x64 * torch.rsqrt((x64 * x64).mean(-1, keepdim=True)
                                  + 1e-6) * w64
        err_k = float((rn.rmsnorm(xr, wr).double() - exact).abs().mean())
        err_p = float((ref.rmsnorm(xr, wr).double() - exact).abs().mean())
        print(f"  rmsnorm {n_rows}x{width} bf16 ({what}; {row_plan_line(plan)}"
              f"): {t_k:.4f} ms (plain {t_p:.4f}, F.rms_norm {t_l:.4f}, "
              f"bound {b_ms:.6f} by {b_by}, {b_ms / t_k:.0%} of it); mean "
              f"|error| vs f64 {err_k:.3e}, plain {err_p:.3e}", flush=True)
        if err_k > err_p:
            fail(f"rmsnorm {n_rows}x{width} bf16: mean error {err_k:.3e} "
                 f"above the plain version's {err_p:.3e}")
        rms_stats[f"{n_rows}x{width}"] = {
            "plan": plan, "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
            "bound_ms": b_ms, "f64_mean_err": [err_k, err_p]}
        if width == d:
            add_row("rmsnorm", t_k, t_p, t_l, ops_n, bytes_n)
    q = rand_t((SERVE_SLOTS, heads, hd), bf)
    kc = rand_t((SERVE_SLOTS, kv_heads, s_dec, hd), bf)
    vc = rand_t((SERVE_SLOTS, kv_heads, s_dec, hd), bf)
    mask = (torch.arange(s_dec, device=dev)[None, :]
            < dec_len[:, None])[:, None, None, :]
    t_k = time_ms(lambda: da.decode_attention(q, kc, vc, dec_len))
    t_p = time_ms(lambda: ref.decode_attention(q, kc, vc, dec_len))
    t_l = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kc, vc, attn_mask=mask, enable_gqa=True))
    valid = float(dec_len.clamp(max=s_dec).sum())
    bytes_n = 2.0 * (2 * q.numel() + 2 * valid * kv_heads * hd)
    ops_n = 4.0 * valid * heads * hd
    b_ms, b_by = bound(bytes_n, ops_n, PEAK_BF16_PER_S)
    print(f"  decode_attention {SERVE_SLOTS}x{heads}/{kv_heads}x{hd}, "
          f"{int(valid)} valid positions of {SERVE_SLOTS * s_dec}, bf16: "
          f"{t_k:.4f} ms (plain {t_p:.4f}, SDPA {t_l:.4f}, bound "
          f"{b_ms:.6f} by {b_by}; {bytes_n / t_k / 1e6:.0f} GB/s)",
          flush=True)
    add_row("decode_attention", t_k, t_p, t_l, ops_n, bytes_n)
    decode_stats = {"qwen2_bf16": {
        "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
        "f64_mean_err": decode_f64_gate(q, kc, vc, dec_len,
                                        f"{SERVE_SLOTS}x{heads}/{kv_heads}"
                                        f"x{hd}")}}
    qf = rand_t((1, heads, s_dec, hd), bf)
    kf = rand_t((1, kv_heads, s_dec, hd), bf)
    vf = rand_t((1, kv_heads, s_dec, hd), bf)
    t_k = time_ms(lambda: fa.flash_attention(qf, kf, vf))
    t_p = time_ms(lambda: ref.attention(qf, kf, vf))
    t_l = time_ms(lambda: F.scaled_dot_product_attention(
        qf, kf, vf, is_causal=True, enable_gqa=True))
    pairs = s_dec * (s_dec + 1) / 2.0
    ops_n = 4.0 * pairs * heads * hd
    bytes_n = 2.0 * (2 * qf.numel() + kf.numel() + vf.numel())
    b_ms, b_by = bound(bytes_n, ops_n, PEAK_BF16_PER_S)
    print(f"  flash_attention (wgmma + TMA) 1x{heads}/{kv_heads}x{s_dec}x{hd} "
          f"causal bf16: {t_k:.4f} ms (plain {t_p:.4f}, SDPA {t_l:.4f}, "
          f"bound {b_ms:.4f} by {b_by} at the bf16 tensor-core peak; "
          f"{ops_n / t_k / 1e9:.1f} TFLOP/s, SDPA "
          f"{ops_n / t_l / 1e9:.1f})", flush=True)
    add_row("flash_attention", t_k, t_p, t_l, ops_n, bytes_n)
    flash_stats = {"qwen2_bf16": {"ms": t_k, "plain_ms": t_p,
                                  "library_ms": t_l, "bound_ms": b_ms,
                                  "tflops": ops_n / t_k / 1e9}}
    # the FFMA kernel keeps the f32 path: timed at the same shape in f32,
    # beside SDPA in f32, its bound at the FP32 rate outside the tensor cores
    q32, k32, v32 = qf.float(), kf.float(), vf.float()
    t_k = time_ms(lambda: fa.flash_attention(q32, k32, v32))
    t_p = time_ms(lambda: ref.attention(q32, k32, v32))
    t_l = time_ms(lambda: F.scaled_dot_product_attention(
        q32, k32, v32, is_causal=True, enable_gqa=True))
    b_ms, b_by = bound(2 * bytes_n, ops_n, PEAK_FP32_PER_S)
    fplan = ffma_flash_plan(hd)
    print(f"  flash_attention_f32 (FFMA; plan {fplan}) 1x{heads}/{kv_heads}x"
          f"{s_dec}x{hd} causal f32: {t_k:.4f} ms (plain {t_p:.4f}, SDPA "
          f"{t_l:.4f}, bound {b_ms:.4f} by {b_by} at the FP32 peak, "
          f"{b_ms / t_k:.0%} of it; {ops_n / t_k / 1e9:.1f} TFLOP/s)",
          flush=True)
    add_row("flash_attention_f32", t_k, t_p, t_l, ops_n, 2 * bytes_n)
    flash_stats["qwen2_f32"] = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                                "bound_ms": b_ms, "plan": fplan}
    # and at recurrentgemma-9b's local attention (D = 256, window 2048),
    # the f32 path of its greedy-token runs
    del q32, k32, v32
    rg_c = get_config("recurrentgemma-9b")
    q32 = rand_t((RG_BATCH, rg_c.n_heads, RG_PROMPT, rg_c.head_dim),
                 torch.float32)
    k32 = rand_t((RG_BATCH, rg_c.n_kv_heads, RG_PROMPT, rg_c.head_dim),
                 torch.float32)
    v32 = rand_t((RG_BATCH, rg_c.n_kv_heads, RG_PROMPT, rg_c.head_dim),
                 torch.float32)
    t_k = time_ms(lambda: fa.flash_attention(q32, k32, v32,
                                             window=rg_c.window))
    t_p = time_ms(lambda: ref.attention(q32, k32, v32, window=rg_c.window))
    t_l = time_ms(lambda: F.scaled_dot_product_attention(
        q32, k32, v32, is_causal=True, enable_gqa=True))   # S <= window
    pairs_rg = RG_PROMPT * (RG_PROMPT + 1) / 2.0
    ops_rg = 4.0 * pairs_rg * RG_BATCH * rg_c.n_heads * rg_c.head_dim
    bytes_rg = 4.0 * (2 * q32.numel() + k32.numel() + v32.numel())
    b_rg, b_rg_by = bound(bytes_rg, ops_rg, PEAK_FP32_PER_S)
    fplan = ffma_flash_plan(rg_c.head_dim)
    print(f"  flash_attention_f32 (FFMA; plan {fplan}) {RG_BATCH}x"
          f"{rg_c.n_heads}/{rg_c.n_kv_heads}x{RG_PROMPT}x{rg_c.head_dim} "
          f"window {rg_c.window} f32: {t_k:.4f} ms (plain {t_p:.4f}, SDPA "
          f"{t_l:.4f}, bound {b_rg:.4f} by {b_rg_by}, {b_rg / t_k:.0%} of "
          f"it; {ops_rg / t_k / 1e9:.1f} TFLOP/s)", flush=True)
    flash_stats["recurrentgemma_f32"] = {
        "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_rg,
        "plan": fplan}
    for name in ("rmsnorm", "decode_attention", "flash_attention"):
        rows[name]["peak"] = PEAK_BF16_PER_S
    del q, kc, vc, qf, kf, vf, mask, q32, k32, v32

    # ---------------------------------------------------------------- 8
    print("phase 8: serving qwen2-1.5b at full width: launch.serve.main("
          f"{' '.join(SERVE_ARGS)} [--prefill-chunk 128])", flush=True)
    need = ("flash_attention", "rmsnorm", "page_gather", "decode_attention")
    serve_stats = {}
    for label, extra in (("serve", []),
                         ("serve chunked", ["--prefill-chunk", "128"])):
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_mod.main(SERVE_ARGS + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = path_counts[label] = counts()
        out = buf.getvalue().strip()
        launched = {n: l for n, (l, _) in c.items() if l}
        print(f"  {' '.join(extra) or 'monolithic prefill'}: {out}; "
              f"{wall:.1f} s with init; launches {launched}", flush=True)
        m = re.search(r"(\d+) requests, (\d+) tokens in (\d+) decode steps, "
                      r"([\d.]+) tok/s", out)
        if rc != 0 or m is None or int(m.group(1)) != 16:
            fail(f"serve.main {label} returned {rc}: {out!r}")
        if any(c[n][0] == 0 for n in need) or any(p for _, p in c.values()):
            fail(f"{label} launched {launched}: every one of {need} must "
                 "launch, and no plain version may run")
        serve_stats[label] = {"tokens": int(m.group(2)),
                              "steps": int(m.group(3)),
                              "tok_per_s": float(m.group(4)),
                              "launches": launched}
        print(f"  {label}: {float(m.group(4)):.1f} tok/s over "
              f"{int(m.group(3))} decode steps", flush=True)

    cfg_full = get_config("qwen2-1.5b")
    model = build_model(cfg_full)
    sparams = serve_mod.cast_compute(model.init(0, dev),
                                     cfg_full.compute_dtype)
    reqs = serve_mod.make_requests(16, prompt_len=512, gen_len=32,
                                   vocab=cfg_full.vocab_size, seed=0,
                                   ragged=True)
    on_cuda = CompileOptions(target="cuda")
    prefill_ms = []
    with use_options(on_cuda):
        def prefill(r):
            toks = torch.as_tensor(r.prompt[None], device=dev)
            return model.prefill(sparams, {"tokens": toks},
                                 max_len=r.prompt_len)
        prefill(reqs[0])
        for r in reqs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(r)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
    mean_prompt = statistics.mean(r.prompt_len for r in reqs)
    print(f"  prefill ms per prompt: {statistics.mean(prefill_ms):.2f} mean "
          f"over 16 prompts of mean length {mean_prompt:.1f} (min "
          f"{min(prefill_ms):.2f}, max {max(prefill_ms):.2f}; host clock, "
          "synchronized)", flush=True)

    # a steady decode step: 8 slots at the first 8 prompts' lengths over
    # a pool sized as serve.main sizes it, filled with seeded values
    per_slot = -(-(512 + 32) // SERVE_BLOCK)
    n_blocks = 1 + per_slot * (SERVE_SLOTS + 1)
    table = (torch.arange(SERVE_SLOTS * per_slot, dtype=torch.int32,
                          device=dev) + 1).view(SERVE_SLOTS, per_slot)
    lengths = torch.tensor([r.prompt_len for r in reqs[:SERVE_SLOTS]],
                           dtype=torch.int32, device=dev)
    token = torch.randint(1, cfg_full.vocab_size, (SERVE_SLOTS,),
                          generator=gen, device=dev, dtype=torch.int32)
    pools = model.init_paged_cache(n_blocks, SERVE_BLOCK, device=dev)
    for key in pools:
        pools[key] = [rand_t(p.shape, p.dtype) for p in pools[key]]

    def step(target):
        with use_options(CompileOptions(target=target)):
            return model.paged_decode_step(sparams, token, pools, table,
                                           lengths, block_size=SERVE_BLOCK)

    step("cuda")
    step("torch")
    reset_counts()
    logits_cuda = step("cuda")[0].float()
    torch.cuda.synchronize()
    step_counts = path_counts["decode step"] = counts()
    logits_torch = step("torch")[0].float()
    # the same step at f32 compute (the bf16 weights and pools widened,
    # plain versions) is the yardstick of both bf16 paths: 28 layers of
    # bf16 activations carry rounding flips to the logits, so the two
    # bf16 paths differ from each other by about as much as each differs
    # from f32; the kernels must be no less accurate than the plain
    # versions (mean |error| within 1.25x of theirs)
    cfg_f32 = dataclasses.replace(cfg_full, compute_dtype="float32")
    with use_options(CompileOptions(target="torch")):
        logits_f32 = build_model(cfg_f32).paged_decode_step(
            serve_mod.cast_compute(sparams, "float32"), token,
            {k: [x.float() for x in v] for k, v in pools.items()}, table,
            lengths, block_size=SERVE_BLOCK)[0]
    diff = (logits_cuda - logits_torch).abs()
    err_c = (logits_cuda - logits_f32).abs()
    err_t = (logits_torch - logits_f32).abs()
    print(f"  one decode step, bf16, against the f32 step: cuda target mean "
          f"|err| {float(err_c.mean()):.5f} (max {float(err_c.max()):.4f}), "
          f"torch target {float(err_t.mean()):.5f} (max "
          f"{float(err_t.max()):.4f}); cuda vs torch mean "
          f"{float(diff.mean()):.5f}, max {float(diff.max()):.4f} of "
          f"max|logits| {float(logits_f32.abs().max()):.3f} (limit: cuda "
          "mean |err| <= 1.25 x torch's)", flush=True)
    if not float(err_c.mean()) <= 1.25 * float(err_t.mean()) or \
            not bool(torch.isfinite(logits_cuda).all()):
        fail("the decode step on the cuda target is less accurate in bf16 "
             "than on the torch target")
    per_step = {n: l for n, (l, p) in step_counts.items() if l}
    print(f"  per-kernel launches per decode step: {per_step}", flush=True)
    if any(p for _, p in step_counts.values()) or \
            per_step.get("decode_attention") != cfg_full.n_layers:
        fail(f"decode step launched {per_step} with plain calls")

    step_stats = {}
    for target in ("cuda", "torch"):
        host_t, wall = host_and_wall(lambda: step(target))
        busy, top, by_name = device_busy(lambda: step(target))
        if busy <= 0:
            fail("the profiler saw no kernel time in the decode step")
        step_stats[target] = {"host_ms": host_t, "wall_ms": wall,
                              "device_busy_ms": busy,
                              "top_kernels_ms": top,
                              "rmsnorm_ms": rms_ms(by_name)}
        print(f"  decode step, {target} target: device busy {busy:.3f} ms "
              f"(profiler), host {host_t:.3f} ms, synchronized wall "
              f"{wall:.3f} ms (host share {host_t / wall:.0%}, device busy "
              f"{busy / wall:.0%})", flush=True)
        print("    largest kernels (ms per step): " + "; ".join(
            f"{name[:60]} {t:.4f}" for name, t in top), flush=True)
        if target == "cuda":
            print(f"    RMSNorm (lapis_rmsnorm*): {rms_ms(by_name):.4f} ms per "
                  f"step over {per_step.get('rmsnorm', 0)} launches "
                  "(profiler)", flush=True)
    del pools, sparams
    torch.cuda.empty_cache()

    # f32 compute: every request's greedy tokens, cuda against torch
    cfg32 = dataclasses.replace(cfg_full, compute_dtype="float32")
    model32 = build_model(cfg32)
    params32 = serve_mod.cast_compute(model32.init(0, dev), "float32")
    tokens32 = {}
    for target in ("cuda", "torch"):
        reset_counts()
        out32 = serve_mod.serve_paged(
            model32, params32,
            serve_mod.make_requests(16, prompt_len=512, gen_len=32,
                                    vocab=cfg32.vocab_size, seed=0,
                                    ragged=True),
            n_slots=SERVE_SLOTS, block_size=SERVE_BLOCK, num_blocks=n_blocks,
            options=CompileOptions(target=target))
        torch.cuda.synchronize()
        c = counts()
        if target == "cuda":
            path_counts["serve f32"] = c
            if any(c[n][0] == 0 for n in at_f32(need)) or \
                    any(p for _, p in c.values()):
                fail(f"f32 serving launched {c} with plain calls")
        tokens32[target] = {r.rid: list(r.tokens) for r in out32["requests"]}
        print(f"  f32 serve_paged on {target}: {out32['tokens']} tokens in "
              f"{out32['steps']} steps, {out32['tok_per_s']:.1f} tok/s",
              flush=True)
    same = sum(tokens32["cuda"][i] == tokens32["torch"][i] for i in range(16))
    print(f"  f32 greedy tokens, cuda vs torch target: {same} of 16 "
          "requests equal", flush=True)
    if same != 16:
        fail("f32 greedy tokens differ between the cuda and torch targets")
    del params32
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 9
    print("phase 9: the recurrent families' kernels vs plain versions on "
          "the card: the RWKV6 and RG-LRU scans, flash and decode attention "
          "at recurrentgemma-9b's 16 / 1 heads x 256", flush=True)
    gen.manual_seed(9)
    rw_cfg, rg_cfg = get_config("rwkv6-3b"), get_config("recurrentgemma-9b")
    rw_h, rw_k = rw_cfg.n_rwkv_heads, rw_cfg.rwkv_head_dim
    rg_d, rg_hq, rg_hkv, rg_hd = (rg_cfg.rglru_dim, rg_cfg.n_heads,
                                  rg_cfg.n_kv_heads, rg_cfg.head_dim)
    rw_b, rw_t = RWKV_BATCH, RWKV_PROMPT
    rg_b, rg_t, ring = RG_BATCH, RG_PROMPT, rg_cfg.window

    def rwkv_inputs(dtype, b=rw_b, t=rw_t, h=rw_h, k=rw_k, state=False,
                    w_range=(0.97, 0.999)):
        """r, k, v (scaled normals), w in [lo, hi) (rwkv6-3b's decays sit
        near 1 at the seeded weights), u, and an optional f32 state."""
        r_, k_, v_ = (rand_t((b, t, h, k), dtype, 0.5) for _ in range(3))
        lo, hi = w_range
        w_ = (lo + (hi - lo) * torch.rand((b, t, h, k), generator=gen,
                                          device=dev)).to(dtype)
        u_ = rand_t((h, k), dtype, 0.1)
        s_ = rand_t((b, h, k, k), torch.float32, 0.5) if state else None
        return r_, k_, v_, w_, u_, s_

    def rglru_inputs(dtype, b=rg_b, t=rg_t, d_=rg_d, state=False):
        x_, r_, i_ = (rand_t((b, t, d_), dtype) for _ in range(3))
        return x_, r_, i_, rand_t((d_,), dtype), \
            (rand_t((b, d_), torch.float32) if state else None)

    def close(name, got, want, tol, what) -> float:
        """Every element within tol + tol × |plain| (assert_allclose with
        rtol = atol = tol, the reference's kernel bar): a scan's values
        grow with T where the decays sit near 1.  Returns the max abs
        error."""
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        diff = (got.float() - want.float()).abs()
        ratio = float((diff / (1.0 + want.float().abs())).max())
        err = float(diff.max())
        ok = ratio <= tol and bool(torch.isfinite(got).all())
        print(f"  {what}: max|kernel - plain| = {err:.3e}, max of it over "
              f"1 + |plain| {ratio:.3e} (limit {tol:.0e}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"{what} disagrees with its plain version")
        worst[name] = max(worst[name], err)
        return err

    def compare_pair(name, got, want, tol, what):
        close(name, got[0], want[0], tol, f"{what} y")
        close(name, got[1], want[1], 2e-4, f"{what} final state (f32)")

    # tests/test_kernels.py's sweeps: (b, t, h, k, v) / (b, t, d)
    rec_sweep = [
        ((2, 16, 3, 8, 16), (2, 16, 32)), ((2, 37, 3, 8, 16), (2, 29, 48)),
        ((2, 64, 3, 8, 16), (2, 64, 128))]
    ring_len = torch.full((rg_b,), ring, dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        tol_y = 2e-4 if dtype == torch.float32 else 2e-2
        for state in (False, True):
            ins = rwkv_inputs(dtype, state=state)
            compare_pair("rwkv6_scan", rw.rwkv6_scan(*ins),
                         ref.rwkv6_scan(*ins), tol_y,
                         f"rwkv6_scan {rw_b}x{rw_t}x{rw_h}x{rw_k} {tag} "
                         f"{'given' if state else 'zero'} state")
            ins = rglru_inputs(dtype, state=state)
            compare_pair("rglru_scan", rg.rglru_scan(*ins),
                         ref.rglru_scan(*ins), tol_y,
                         f"rglru_scan {rg_b}x{rg_t}x{rg_d} {tag} "
                         f"{'given' if state else 'zero'} state")
        # decays a trained model reaches: underflowed (exp(-exp(x)) below
        # 1e-6, and 0) and none (w = 1, the state only grows)
        for w_range in ((0.0, 1e-6), (0.0, 0.0), (1.0, 1.0)):
            ins = rwkv_inputs(dtype, state=True, w_range=w_range)
            compare_pair("rwkv6_scan", rw.rwkv6_scan(*ins),
                         ref.rwkv6_scan(*ins), tol_y,
                         f"rwkv6_scan {rw_b}x{rw_t}x{rw_h}x{rw_k} {tag} "
                         f"decays in {list(w_range)}, given state")
        ins = rglru_inputs(dtype, t=1, state=True)
        compare_pair("rglru_scan", rg.rglru_scan(*ins), ref.rglru_scan(*ins),
                     tol_y, f"rglru_scan decode step {rg_b}x1x{rg_d} {tag}")
        for (b_, t_, h_, k_, v_), (gb, gt, gd) in rec_sweep:
            r_, k2, _, w_, u_, s_ = rwkv_inputs(dtype, b_, t_, h_, k_, True)
            v2 = rand_t((b_, t_, h_, v_), dtype, 0.5)
            s_ = rand_t((b_, h_, k_, v_), torch.float32, 0.5)
            ins = (r_, k2, v2, w_, u_, s_)
            compare_pair("rwkv6_scan", rw.rwkv6_scan(*ins),
                         ref.rwkv6_scan(*ins), tol_y,
                         f"rwkv6_scan sweep {b_}x{t_}x{h_}x{k_}/{v_} {tag}")
            ins = rglru_inputs(dtype, gb, gt, gd, True)
            compare_pair("rglru_scan", rg.rglru_scan(*ins),
                         ref.rglru_scan(*ins), tol_y,
                         f"rglru_scan sweep {gb}x{gt}x{gd} {tag}")
        qf = rand_t((rg_b, rg_hq, rg_t, rg_hd), dtype)
        kf = rand_t((rg_b, rg_hkv, rg_t, rg_hd), dtype)
        vf = rand_t((rg_b, rg_hkv, rg_t, rg_hd), dtype)
        compare("flash_attention" if dtype == torch.bfloat16
                else "flash_attention_f32",
                fa.flash_attention(qf, kf, vf, window=ring),
                ref.attention(qf, kf, vf, window=ring), tol_y,
                f"flash_attention {rg_b}x{rg_hq}/{rg_hkv}x{rg_t}x{rg_hd} "
                f"causal window {ring} {tag}")
        q = rand_t((rg_b, rg_hq, rg_hd), dtype)
        kc = rand_t((rg_b, rg_hkv, ring, rg_hd), dtype)
        vc = rand_t((rg_b, rg_hkv, ring, rg_hd), dtype)
        for n_valid in (rg_t + 1, ring):   # the first step, and past the wrap
            lens = torch.full((rg_b,), n_valid, dtype=torch.int32, device=dev)
            compare("decode_attention", da.decode_attention(q, kc, vc, lens),
                    ref.decode_attention(q, kc, vc, lens), tol_y,
                    f"decode_attention ring {rg_b}x{rg_hq}/{rg_hkv}x{rg_hd} "
                    f"{n_valid} of {ring} slots {tag}")
        del qf, kf, vf, q, kc, vc

    # times in bf16, the serving dtype, at the prefill / decode shapes
    recurrent_kernel_stats = {}
    ins = rwkv_inputs(bf)[:5]
    wplan = wkv_plan(rw_b, rw_t, rw_h, rw_k, rw_k, bf)
    t_k = time_ms(lambda: rw.rwkv6_scan(*ins))
    t_p = time_ms(lambda: ref.rwkv6_scan(*ins))
    n_in = rw_b * rw_t * rw_h * rw_k
    bytes_n = 2.0 * (5 * n_in + rw_h * rw_k) + 4.0 * rw_b * rw_h * rw_k ** 2
    # per (t, k, v) an FMA for y and a multiply and an FMA for S; per step
    # c_t = sum_k r u k (3 K) and y += v c_t (2 V), with K = V
    ops_n = n_in * (5.0 * rw_k + 5.0)
    b_ms, b_by = bound(bytes_n, ops_n, PEAK_FP32_PER_S)
    print(f"  rwkv6_scan {rw_b}x{rw_t}x{rw_h}x{rw_k} bf16 (plan {wplan}): "
          f"{t_k:.4f} ms (plain {t_p:.4f}, no library call, bound "
          f"{b_ms:.6f} by {b_by}, {b_ms / t_k:.0%} of it: "
          f"{bytes_n / 1e6:.1f} MB, {ops_n / 1e9:.2f} GFLOP f32)", flush=True)
    add_row("rwkv6_scan", t_k, t_p, 0.0, ops_n, bytes_n)
    recurrent_kernel_stats["rwkv6_scan"] = {"ms": t_k, "plain_ms": t_p,
                                            "bound_ms": b_ms, "plan": wplan}
    # the same scan in f32 (the greedy-token runs' compute), the bound
    # counting 4-byte inputs
    ins = rwkv_inputs(torch.float32)[:5]
    wplan = wkv_plan(rw_b, rw_t, rw_h, rw_k, rw_k, torch.float32)
    t_k = time_ms(lambda: rw.rwkv6_scan(*ins))
    t_p = time_ms(lambda: ref.rwkv6_scan(*ins))
    b_32, b_32by = bound(2.0 * bytes_n - 4.0 * rw_b * rw_h * rw_k ** 2,
                         ops_n, PEAK_FP32_PER_S)
    print(f"  rwkv6_scan {rw_b}x{rw_t}x{rw_h}x{rw_k} f32 (plan {wplan}): "
          f"{t_k:.4f} ms (plain {t_p:.4f}, bound {b_32:.6f} by {b_32by}, "
          f"{b_32 / t_k:.0%} of it)", flush=True)
    recurrent_kernel_stats["rwkv6_scan_f32"] = {
        "ms": t_k, "plain_ms": t_p, "bound_ms": b_32, "plan": wplan}
    ins = rglru_inputs(bf)[:4]
    plan = rglru_plan(rg_b, rg_t, rg_d, bf)
    t_k = time_ms(lambda: rg.rglru_scan(*ins))
    t_p = time_ms(lambda: ref.rglru_scan(*ins))
    n_el = rg_b * rg_t * rg_d
    bytes_n = 2.0 * (4 * n_el + rg_d) + 4.0 * rg_b * rg_d
    ops_n = 17.0 * n_el
    b_ms, b_by = bound(bytes_n, ops_n, PEAK_FP32_PER_S)
    print(f"  rglru_scan {rg_b}x{rg_t}x{rg_d} bf16 (plan {plan}): {t_k:.4f} "
          f"ms (plain {t_p:.4f}, no library call, bound {b_ms:.6f} by "
          f"{b_by}: {bytes_n / 1e6:.1f} MB; {bytes_n / t_k / 1e6:.0f} GB/s)",
          flush=True)
    add_row("rglru_scan", t_k, t_p, 0.0, ops_n, bytes_n)
    recurrent_kernel_stats["rglru_scan"] = {"ms": t_k, "plain_ms": t_p,
                                            "bound_ms": b_ms, "plan": plan}
    # the serving decode step's scan: T = 1 against the cached h
    ins = rglru_inputs(bf, t=1, state=True)
    plan = rglru_plan(rg_b, 1, rg_d, bf)
    t_k = time_ms(lambda: rg.rglru_scan(*ins))
    t_p = time_ms(lambda: ref.rglru_scan(*ins))
    bytes_d = 2.0 * (4 * rg_b * rg_d + rg_d) + 8.0 * rg_b * rg_d
    b_d, b_dby = bound(bytes_d, 17.0 * rg_b * rg_d, PEAK_FP32_PER_S)
    print(f"  rglru_scan decode step {rg_b}x1x{rg_d} bf16, given state (plan "
          f"{plan}): {t_k:.4f} ms (plain {t_p:.4f}, bound {b_d:.6f} by "
          f"{b_dby})", flush=True)
    recurrent_kernel_stats["rglru_scan_decode"] = {
        "ms": t_k, "plain_ms": t_p, "bound_ms": b_d, "plan": plan}
    for name in ("rwkv6_scan", "rglru_scan"):
        rows[name]["library_ms"] = None     # no one torch call scans
    qf = rand_t((rg_b, rg_hq, rg_t, rg_hd), bf)
    kf = rand_t((rg_b, rg_hkv, rg_t, rg_hd), bf)
    vf = rand_t((rg_b, rg_hkv, rg_t, rg_hd), bf)
    t_k = time_ms(lambda: fa.flash_attention(qf, kf, vf, window=ring))
    t_p = time_ms(lambda: ref.attention(qf, kf, vf, window=ring))
    t_l = time_ms(lambda: F.scaled_dot_product_attention(
        qf, kf, vf, is_causal=True, enable_gqa=True))   # S <= window
    pairs = rg_t * (rg_t + 1) / 2.0
    ops_n = 4.0 * pairs * rg_b * rg_hq * rg_hd
    bytes_n = 2.0 * (2 * qf.numel() + kf.numel() + vf.numel())
    b_ms, b_by = bound(bytes_n, ops_n, PEAK_BF16_PER_S)
    print(f"  flash_attention (wgmma + TMA) {rg_b}x{rg_hq}/{rg_hkv}x{rg_t}x"
          f"{rg_hd} window {ring} bf16: {t_k:.4f} ms (plain {t_p:.4f}, SDPA "
          f"{t_l:.4f}, bound {b_ms:.4f} by {b_by} at the bf16 tensor-core "
          f"peak; {ops_n / t_k / 1e9:.1f} TFLOP/s, SDPA "
          f"{ops_n / t_l / 1e9:.1f})", flush=True)
    add_row("flash_attention", t_k, t_p, t_l, ops_n, bytes_n)
    recurrent_kernel_stats["flash_attention_d256"] = flash_stats[
        "recurrentgemma_bf16"] = {"ms": t_k, "plain_ms": t_p,
                                  "library_ms": t_l, "bound_ms": b_ms,
                                  "tflops": ops_n / t_k / 1e9}
    q = rand_t((rg_b, rg_hq, rg_hd), bf)
    kc = rand_t((rg_b, rg_hkv, ring, rg_hd), bf)
    vc = rand_t((rg_b, rg_hkv, ring, rg_hd), bf)
    t_k = time_ms(lambda: da.decode_attention(q, kc, vc, ring_len))
    t_p = time_ms(lambda: ref.decode_attention(q, kc, vc, ring_len))
    t_l = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kc, vc, enable_gqa=True))     # every slot valid
    valid = float(rg_b * ring)
    bytes_n = 2.0 * (2 * q.numel() + 2 * valid * rg_hkv * rg_hd)
    ops_n = 4.0 * valid * rg_hq * rg_hd
    b_ms, b_by = bound(bytes_n, ops_n, PEAK_BF16_PER_S)
    print(f"  decode_attention ring {rg_b}x{rg_hq}/{rg_hkv}x{rg_hd} over "
          f"{ring} slots bf16: {t_k:.4f} ms (plain {t_p:.4f}, SDPA "
          f"{t_l:.4f}, bound {b_ms:.6f} by {b_by}; "
          f"{bytes_n / t_k / 1e6:.0f} GB/s)", flush=True)
    add_row("decode_attention", t_k, t_p, t_l, ops_n, bytes_n)
    recurrent_kernel_stats["decode_attention_ring"] = decode_stats[
        "recurrentgemma_bf16"] = {
        "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
        "f64_mean_err": decode_f64_gate(q, kc, vc, ring_len,
                                        f"ring {rg_b}x{rg_hq}/{rg_hkv}x"
                                        f"{rg_hd}")}
    rows["rwkv6_scan"]["peak"] = rows["rglru_scan"]["peak"] = PEAK_FP32_PER_S
    del qf, kf, vf, q, kc, vc, ins
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 10, 11
    def serve_recurrent(phase, arch, n_req, batch, plen, glen, need,
                        per_step_want):
        """Serve ``arch`` at full width through ``launch.serve.main`` with
        the counts zeroed before and read after; then prefill ms, the
        decode step's host and device time and its launches per kernel,
        and the f32 greedy tokens of every request on ``cuda`` against
        ``torch``.  Each model is freed before the next."""
        argv = ["--arch", arch, "--target", "cuda", "--requests",
                str(n_req), "--batch", str(batch), "--prompt-len",
                str(plen), "--gen-len", str(glen), "--seed", "0"]
        print(f"phase {phase}: serving {arch} at full width: "
              f"launch.serve.main({' '.join(argv)})", flush=True)
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = path_counts[f"serve {arch}"] = counts()
        out = buf.getvalue().strip()
        launched = {n: l for n, (l, _) in c.items() if l}
        print(f"  {out}; {wall:.1f} s with init; launches {launched}",
              flush=True)
        m = re.search(r"\[serve\] (\d+) requests, (\d+) tokens, "
                      r"([\d.]+) tok/s", out)
        if rc != 0 or m is None or int(m.group(1)) != n_req:
            fail(f"serve.main {arch} returned {rc}: {out!r}")
        if any(c[n][0] == 0 for n in need) or any(p for _, p in c.values()):
            fail(f"{arch} launched {launched}: every one of {need} must "
                 "launch, and no plain version may run")
        torch.cuda.empty_cache()
        stats = {"tok_per_s": float(m.group(3)), "wall_s": wall,
                 "launches": launched}

        cfg_a = get_config(arch)
        model = build_model(cfg_a)
        sparams = serve_mod.cast_compute(model.init(0, dev),
                                         cfg_a.compute_dtype)
        prng = np.random.default_rng(0)     # serve_loop's prompts
        queue = [prng.integers(1, cfg_a.vocab_size, plen)
                 for _ in range(n_req)]
        waves = [np.stack(queue[i:i + batch])
                 for i in range(0, n_req, batch)]
        toks = torch.as_tensor(waves[0], dtype=torch.int32, device=dev)
        with use_options(CompileOptions(target="cuda")):
            def prefill():
                return model.prefill(sparams, {"tokens": toks},
                                     max_len=plen + glen)
            prefill()
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = prefill()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            busy, top, by_name = device_busy(prefill, n=2)
        stats["prefill_ms"] = statistics.median(times)
        stats["prefill_device_busy_ms"] = busy
        stats["prefill_top_kernels_ms"] = top
        stats["prefill_rglru_ms"] = rms_ms(by_name, "lapis_rglru")
        stats["prefill_rwkv6_ms"] = rms_ms(by_name, "lapis_rwkv6")
        print(f"  wave prefill of {batch} x {plen} tokens (bf16): "
              f"{stats['prefill_ms']:.2f} ms (median of 3, host clock, "
              f"synchronized); device busy {busy:.2f} ms (profiler)",
              flush=True)
        print("    largest prefill kernels (ms per prefill): " + "; ".join(
            f"{name[:60]} {t:.4f}" for name, t in top), flush=True)
        if "rglru_scan" in need:
            print(f"    RG-LRU (lapis_rglru*): {stats['prefill_rglru_ms']:.4f} "
                  "ms per prefill (profiler)", flush=True)
        if "rwkv6_scan" in need:
            print(f"    WKV (lapis_rwkv6*): {stats['prefill_rwkv6_ms']:.4f} "
                  "ms per prefill (profiler)", flush=True)
        tok = torch.argmax(logits[:, :cfg_a.vocab_size], -1).to(torch.int32)

        def step(target):
            with use_options(CompileOptions(target=target)):
                return model.decode_step(sparams, tok, cache, plen)

        step("cuda")
        step("torch")
        reset_counts()
        logits_c = step("cuda")[0]
        torch.cuda.synchronize()
        sc = path_counts[f"{arch} decode step"] = counts()
        per_step = {n: l for n, (l, _) in sc.items() if l}
        print(f"  per-kernel launches per decode step: {per_step}",
              flush=True)
        if per_step != per_step_want or any(p for _, p in sc.values()):
            fail(f"{arch} decode step launched {per_step}, want "
                 f"{per_step_want}, with no plain call")
        if not bool(torch.isfinite(logits_c).all()):
            fail(f"{arch} decode step logits are not finite")
        stats["decode_launches"] = per_step
        for target in ("cuda", "torch"):
            host_t, wall_t = host_and_wall(lambda: step(target))
            busy, top, by_name = device_busy(lambda: step(target))
            if busy <= 0:
                fail("the profiler saw no kernel time in the decode step")
            stats[f"decode_{target}"] = {
                "host_ms": host_t, "wall_ms": wall_t,
                "device_busy_ms": busy, "top_kernels_ms": top,
                "rmsnorm_ms": rms_ms(by_name),
                "rglru_ms": rms_ms(by_name, "lapis_rglru")}
            print(f"  decode step, {target} target: device busy "
                  f"{busy:.3f} ms (profiler), host {host_t:.3f} ms, "
                  f"synchronized wall {wall_t:.3f} ms (host share "
                  f"{host_t / wall_t:.0%}, device busy {busy / wall_t:.0%})",
                  flush=True)
            print("    largest kernels (ms per step): " + "; ".join(
                f"{name[:60]} {t:.4f}" for name, t in top), flush=True)
            if target == "cuda":
                print(f"    RMSNorm (lapis_rmsnorm*): {rms_ms(by_name):.4f} ms "
                      f"per step over {per_step.get('rmsnorm', 0)} launches "
                      "(profiler)", flush=True)
                if "rglru_scan" in per_step:
                    print("    RG-LRU (lapis_rglru*): "
                          f"{rms_ms(by_name, 'lapis_rglru'):.4f} ms per step "
                          f"over {per_step['rglru_scan']} launches "
                          "(profiler)", flush=True)
        del sparams, cache, logits, logits_c, model
        torch.cuda.empty_cache()

        cfg32 = dataclasses.replace(cfg_a, compute_dtype="float32")
        model32 = build_model(cfg32)
        params32 = serve_mod.cast_compute(model32.init(0, dev), "float32")
        tokens32 = {}
        for target in ("cuda", "torch"):
            reset_counts()
            t0 = time.perf_counter()
            with use_options(CompileOptions(target=target)):
                tokens32[target] = np.concatenate([
                    serve_mod.generate(model32, params32, w, gen_len=glen,
                                       max_len=plen + glen)
                    for w in waves])
            torch.cuda.synchronize()
            c = counts()
            if target == "cuda":
                path_counts[f"{arch} f32"] = c
                if any(c[n][0] == 0 for n in at_f32(need)) or \
                        any(p for _, p in c.values()):
                    fail(f"{arch} f32 generate launched {c} with plain "
                         "calls")
            print(f"  f32 generate on {target}: {tokens32[target].size} "
                  f"tokens in {time.perf_counter() - t0:.1f} s", flush=True)
        same = int(sum(np.array_equal(a, b) for a, b in
                       zip(tokens32["cuda"], tokens32["torch"])))
        print(f"  f32 greedy tokens, cuda vs torch target: {same} of "
              f"{n_req} requests equal", flush=True)
        if same != n_req:
            fail(f"{arch}: f32 greedy tokens differ between the cuda and "
                 "torch targets")
        stats["f32_requests_equal"] = same
        del params32, model32
        torch.cuda.empty_cache()
        return stats

    L_rw = rw_cfg.n_layers
    rwkv_stats = serve_recurrent(
        10, "rwkv6-3b", RWKV_REQUESTS, rw_b, rw_t, RWKV_GEN,
        ("rwkv6_scan", "rmsnorm"), {"rmsnorm": 2 * L_rw + 1})
    n_groups, n_rem = divmod(rg_cfg.n_layers, len(rg_cfg.pattern))
    n_a = n_groups * rg_cfg.pattern.count("A") + \
        rg_cfg.pattern[:n_rem].count("A")
    rg_stats = serve_recurrent(
        11, "recurrentgemma-9b", RG_REQUESTS, rg_b, rg_t, RG_GEN,
        ("rglru_scan", "rmsnorm", "flash_attention", "decode_attention"),
        {"rglru_scan": rg_cfg.n_layers - n_a, "decode_attention": n_a,
         "rmsnorm": 2 * rg_cfg.n_layers + 1})

    # ---------------------------------------------------------------- 12
    print("phase 12: batched products through pipeline.compile(ops.matmul, "
          "target='cuda'), f32 and bf16", flush=True)

    batched_stats = []
    for (sa, sb, dt), bmod in bmm_mods.items():
        (op,) = [o for o in bmod.graph.ops if o.opname == "kk.batched_gemm"]
        tiling = op.attrs["tiling"]
        tdt = getattr(torch, dt)
        a = randn(*sa).to(tdt)
        b = randn(*sb, scale=sb[-2] ** -0.5).to(tdt)
        label = f"{'x'.join(map(str, sa))} @ {'x'.join(map(str, sb))} {dt}"
        plan = None if tiling["vectorize_batch"] else bgm.plan_for(a, b)
        if plan is None:
            name = "batched_gemm_small"
        elif plan["route"] == ("wgmma" if dt == "bfloat16" else "ffma"):
            name = ("batched_gemm_tiled_bf16" if dt == "bfloat16"
                    else "batched_gemm_tiled")
        else:
            fail(f"batched {label} planned the {plan['route']} route")
        reset_counts()
        got = bmod(a, b)
        torch.cuda.synchronize()
        c = path_counts[f"batched {label}"] = counts()
        launched = {n: l for n, (l, _) in c.items() if l}
        if launched != {name: 1} or any(p for _, p in c.values()):
            fail(f"batched {label} launched {launched}, want {{{name}: 1}} "
                 "with no plain call")
        tol = 2e-4 if dt == "float32" else 2e-2
        err = close(name, got, ref.batched_gemm(a, b), tol,
                    f"{name} {label} tiling {tiling}")
        nb = int(np.prod(sa[:-2]))
        m, k, n = sa[-2], sa[-1], sb[-1]
        item = a.element_size()
        ops_n = 2.0 * nb * m * n * k
        bytes_n = item * (a.numel() + b.numel() + got.numel())
        peak = PEAK_FP32_PER_S if dt == "float32" else PEAK_BF16_PER_S
        b_ms, b_by = bound(bytes_n, ops_n, peak)
        t_k = time_ms(lambda: bmod(a, b))
        t_p = time_ms(lambda: ref.batched_gemm(a, b))
        t_l = time_ms(lambda: torch.matmul(a, b))
        print(f"  {label}: {t_k:.4f} ms (plain {t_p:.4f}, torch.matmul "
              f"{t_l:.4f}, bound {b_ms:.4f} by {b_by}; "
              f"{ops_n / t_k / 1e9:.1f} TFLOP/s)"
              + ("" if plan is None else f"; {plan_line(plan)}"), flush=True)
        batched_stats.append({"a": sa, "b": sb, "dtype": dt, "kernel": name,
                              "tiling": tiling, "ms": t_k, "plain_ms": t_p,
                              "library_ms": t_l, "bound_ms": b_ms,
                              "bound_by": b_by, "max_abs_err": err,
                              "route": None if plan is None
                              else plan["route"]})
        # the kernels line: the small kernel's f32 cases, the tiled
        # products' f32 (FFMA) and bf16 (wgmma) cases each in their row
        if dt == "float32" or name == "batched_gemm_tiled_bf16":
            add_row(name, t_k, t_p, t_l, ops_n, bytes_n)
        del a, b, got

    # an eager call on card tensors (no tiling: the pass's choice for the
    # shapes) and a 4-D batch through the compiler
    a, b = randn(96, 24, 40), randn(96, 40, 24, scale=40 ** -0.5)
    reset_counts()
    with use_options(CompileOptions(target="cuda")):
        got = ops.matmul(a, b)
    torch.cuda.synchronize()
    c = path_counts["batched eager 96x24x40"] = counts()
    if c["batched_gemm_small"] != (1, 0) or \
            sum(l for l, _ in c.values()) != 1:
        fail(f"eager ops.matmul on card tensors launched {c}")
    close("batched_gemm_small", got, ref.batched_gemm(a, b), 2e-4,
          "batched_gemm_small eager ops.matmul 96x24x40 @ 96x40x24")
    sa4, sb4 = (2, 3, 200, 96), (2, 3, 96, 130)
    a, b = randn(*sa4), randn(*sb4, scale=96 ** -0.5)
    mod4 = pipeline.compile(bmm, TensorSpec(sa4, "float32"),
                            TensorSpec(sb4, "float32"),
                            options=CompileOptions(target="cuda"))
    reset_counts()
    got = mod4(a, b)
    torch.cuda.synchronize()
    c = path_counts["batched 4-D 2x3x200x96"] = counts()
    if c["batched_gemm_tiled"] != (1, 0) or \
            sum(l for l, _ in c.values()) != 1:
        fail(f"the 4-D batched product launched {c}")
    close("batched_gemm_tiled", got, ref.batched_gemm(a, b), 2e-4,
          "batched_gemm_tiled 4-D 2x3x200x96 @ 2x3x96x130")
    del a, b, got

    # ---------------------------------------------------------------- 13
    print(f"phase 13: ResNet18 at full width (width 1.0, 1000 classes), "
          f"batch {RESNET_BATCH}, {RESNET_RES}x{RESNET_RES}, f32, "
          "pipeline.compile for cuda and torch; cuDNN convolutions with "
          f"TF32 off (allow_tf32={torch.backends.cudnn.allow_tf32})",
          flush=True)
    rn_lib = pipeline.compile(rn_fn, rn_spec,
                              options=CompileOptions(target="torch"))
    xr = torch.from_numpy(np.random.default_rng(2).standard_normal(
        rn_spec.shape).astype(np.float32)).to(dev)
    reset_counts()
    probs = rn_mod(xr)
    torch.cuda.synchronize()
    c = path_counts["resnet18"] = counts()
    launched = {n: l for n, (l, _) in c.items() if l}
    ops_by_name = {}
    for op in rn_mod.graph.ops:
        ops_by_name[op.opname] = ops_by_name.get(op.opname, 0) + 1
    print(f"  IR ops {ops_by_name}; launch_count {rn_mod.launch_count}; "
          f"launches {launched}", flush=True)
    if any(c[n][0] == 0 for n in ("matmul", "block_map_region",
                                  "row_softmax")) or \
            any(p for _, p in c.values()):
        fail(f"ResNet18 launched {launched}: the gemm, nest and softmax "
             "kernels must each launch, and no plain version may run")
    probs_lib = rn_lib(xr)
    # the same network in f64 (torch target) as the yardstick of both f32
    # targets: the seeded full-width logits reach ~200, so a few ulp of
    # f32 sum order in the fc product (K = 512) move the probabilities by
    # ~1e-4 of themselves
    def to64(t):
        return ({k: to64(v) for k, v in t.items()} if isinstance(t, dict)
                else t.double())

    rn_w64 = to64(rn_w)
    probs64 = pipeline.compile(
        lambda xv: resnet.resnet18_forward(rn_w64, xv),
        TensorSpec(rn_spec.shape, "float64"),
        options=CompileOptions(target="torch"))(xr.double())
    torch.cuda.synchronize()

    def rel_err(p, want) -> float:
        keep = want.double() > 1e-6
        return float(((p.double() - want.double()).abs()
                      / want.double())[keep].max())
    err = float((probs - probs_lib).abs().max())
    rel_pair = rel_err(probs, probs_lib)
    rel_cuda, rel_torch = rel_err(probs, probs64), rel_err(probs_lib,
                                                           probs64)
    row_err = float((probs.sum(-1) - 1).abs().max())
    tight = torch.allclose(probs, probs_lib, rtol=1e-4, atol=1e-6)
    ok = (tuple(probs.shape) == (RESNET_BATCH, 1000)
          and bool(torch.isfinite(probs).all())
          and torch.allclose(probs, probs_lib, rtol=1e-3, atol=1e-6)
          and max(rel_cuda, rel_torch) <= 1e-3
          and torch.equal(probs.argmax(-1), probs_lib.argmax(-1))
          and row_err <= 1e-3)
    print(f"  cuda vs torch target: max abs err {err:.3e}, max rel err "
          f"{rel_pair:.3e} over p > 1e-6 (limit rtol 1e-3, atol 1e-6; "
          f"within rtol 1e-4: {tight}); "
          f"against f64: cuda {rel_cuda:.3e}, torch {rel_torch:.3e} "
          f"(limit 1e-3); rows sum to 1 within {row_err:.1e} (limit "
          f"1e-3); top-1 classes {probs.argmax(-1).tolist()}", flush=True)
    if not ok:
        fail("ResNet18 on the cuda target disagrees with the torch target")
    del rn_w64, probs64
    rn_ms = time_ms(lambda: rn_mod(xr), with_host=True)
    rn_lib_ms = time_ms(lambda: rn_lib(xr), with_host=True)
    rn_busy, rn_top, rn_by = device_busy(lambda: rn_mod(xr))
    rn_nest_ms = rms_ms(rn_by, "map_kernel")
    print(f"  compiled call: cuda target {rn_ms:.4f} ms, torch target "
          f"{rn_lib_ms:.4f} ms (with the host's share); cuda device busy "
          f"{rn_busy:.4f} ms (profiler), of it the 17 nests "
          f"{rn_nest_ms:.4f} ms", flush=True)
    print("    largest kernels (ms per call): " + "; ".join(
        f"{nm[:60]} {t:.4f}" for nm, t in rn_top), flush=True)
    # §4.3 DualView ablation (benchmarks/resnet_bench.py): weights on the
    # host, transfers of one call with lazy sync against the eager
    # baseline's round trip around every kernel
    rn_host_w = resnet.init_resnet18_weights(np.random.default_rng(0),
                                             device="cpu")
    ablation = {}
    for lazy in (True, False):
        m_ab = pipeline.compile(
            lambda xv: resnet.resnet18_forward(rn_host_w, xv), rn_spec,
            options=CompileOptions(target="cuda", lazy_dualview=lazy))
        reset_transfer_stats()
        m_ab(xr)
        torch.cuda.synchronize()
        h2d, d2h = TRANSFERS["h2d"], TRANSFERS["d2h"]
        _, wall_t = host_and_wall(lambda: m_ab(xr), n=3)
        ablation["lazy" if lazy else "eager"] = {
            "h2d": h2d, "d2h": d2h, "wall_ms_later_calls": wall_t}
        print(f"  lazy_dualview={lazy}: first call h2d {h2d} + d2h {d2h} = "
              f"{h2d + d2h}; later calls {wall_t:.2f} ms (synchronized "
              "wall)", flush=True)
        del m_ab
    # the fc gemm alone (8 x 512 x 1000, f32): split-K, the same bits on
    # every call
    (fc_op,) = [op for op in rn_mod.graph.ops if op.opname == "kk.gemm"]
    (fm, fk), (_, fn) = (o.type.shape for o in fc_op.operands)
    fa_ = randn(fm, fk)
    fb_ = rn_w["fc_w"]
    fc_plan = mm.plan_for(fa_, fb_)
    fc_out = mm.matmul(fa_, fb_, tiling=fc_op.attrs["tiling"])
    fc_err = compare("matmul", fc_out, ref.matmul(fa_, fb_), 1e-5,
                     f"matmul ResNet18 fc {fm}x{fk}x{fn}")
    stable = all(torch.equal(mm.matmul(fa_, fb_), fc_out) for _ in range(3))
    if fc_plan["split"] < 2 or not stable:
        fail(f"the fc gemm: split {fc_plan['split']}, bitwise stable "
             f"{stable}")
    fc_ms = time_ms(lambda: mm.matmul(fa_, fb_))
    fc_lib_ms = time_ms(lambda: torch.matmul(fa_, fb_))
    fc_bound, fc_by = bound(4.0 * (fm * fk + fk * fn + fm * fn),
                            2.0 * fm * fk * fn)
    print(f"  fc gemm {fm}x{fk}x{fn} f32 ({plan_line(fc_plan)}): "
          f"{fc_ms:.4f} ms (torch.matmul {fc_lib_ms:.4f}, bound "
          f"{fc_bound:.6f} by {fc_by}); bitwise equal over calls: {stable}",
          flush=True)
    resnet_stats = {"ms": rn_ms, "library_ms": rn_lib_ms,
                    "device_busy_ms": rn_busy, "nests_device_ms": rn_nest_ms,
                    "launches": launched,
                    "max_abs_err": err, "max_rel_err": rel_pair,
                    "rel_err_vs_f64": {"cuda": rel_cuda, "torch": rel_torch},
                    "dualview": ablation,
                    "fc_gemm": {"ms": fc_ms, "library_ms": fc_lib_ms,
                                "bound_ms": fc_bound, "split":
                                fc_plan["split"], "max_abs_err": fc_err}}
    del rn_mod, rn_lib, rn_host_w, probs, probs_lib, xr
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 14
    print(f"phase 14: MALA LDOS surrogate (91 -> 400 x3 -> 201) on "
          f"{MALA_POINTS} points, f32, pipeline.compile for cuda and torch",
          flush=True)
    mala_lib = pipeline.compile(mala_fn, mala_spec,
                                options=CompileOptions(target="torch"))
    xm = torch.from_numpy(np.random.default_rng(3).standard_normal(
        mala_spec.shape).astype(np.float32)).to(dev)
    reset_counts()
    ym = mala_mod(xm)
    torch.cuda.synchronize()
    c = path_counts["mala"] = counts()
    launched = {n: l for n, (l, _) in c.items() if l}
    n_layers = len([k for k in mala_w if k.startswith("w")])
    print(f"  launch_count {mala_mod.launch_count}; launches {launched}",
          flush=True)
    if c["matmul"] != (n_layers, 0) or any(p for _, p in c.values()):
        fail(f"MALA launched {launched}: want {n_layers} gemm kernels and "
             "no plain version")
    ym_lib = mala_lib(xm)
    torch.cuda.synchronize()
    err = float((ym - ym_lib).abs().max())
    limit = 1e-4 * float(ym_lib.abs().max())
    print(f"  cuda vs torch target: max abs err {err:.3e} (limit "
          f"{limit:.3e}, 1e-4 of max|y|)", flush=True)
    if not (err <= limit and bool(torch.isfinite(ym).all())
            and tuple(ym.shape) == (MALA_POINTS, 201)):
        fail("MALA on the cuda target disagrees with the torch target")
    mala_ms = time_ms(lambda: mala_mod(xm), with_host=True)
    mala_lib_ms = time_ms(lambda: mala_lib(xm), with_host=True)
    mala_dev_ms = time_ms(lambda: mala_mod(xm))
    mala_lib_dev_ms = time_ms(lambda: mala_lib(xm))
    print(f"  compiled call: cuda target {mala_ms:.4f} ms, torch target "
          f"{mala_lib_ms:.4f} ms; device time alone {mala_dev_ms:.4f} / "
          f"{mala_lib_dev_ms:.4f} ms", flush=True)
    mala_stats = {"ms": mala_ms, "library_ms": mala_lib_ms,
                  "device_ms": mala_dev_ms,
                  "library_device_ms": mala_lib_dev_ms,
                  "launches": launched, "max_abs_err": err}

    # ---------------------------------------------------------------- 16
    train_stats = training_phase(torch, np, dev, get_config, CompileOptions,
                                 use_options, reset_counts, counts,
                                 path_counts, compare)

    # ---------------------------------------------------------------- 17
    translate_stats = translate_phase({
        "reset_counts": reset_counts, "counts": counts,
        "path_counts": path_counts, "time_ms": time_ms, "compare": compare,
        "rn_fn": rn_fn, "rn_spec": rn_spec, "mm": mm})

    # ---------------------------------------------------------------- 18
    families_stats = families_phase({
        "reset_counts": reset_counts, "counts": counts,
        "path_counts": path_counts, "time_ms": time_ms, "compare": compare,
        "host_and_wall": host_and_wall, "device_busy": device_busy,
        "dev": dev})

    # ---------------------------------------------------------------- 19
    distribution_stats = distribution_phase({
        "reset_counts": reset_counts, "counts": counts,
        "path_counts": path_counts, "compare": compare, "dev": dev,
        "train_stats": train_stats})

    # ---------------------------------------------------------------- 20
    verification_stats = verification_phase({
        "reset_counts": reset_counts, "counts": counts,
        "path_counts": path_counts, "time_ms": time_ms, "dev": dev,
        "block": (block, spec, x), "block16": (block16, spec16, x16),
        "rn_fn": rn_fn, "rn_spec": rn_spec, "rn_w": rn_w,
        "mala_fn": mala_fn, "mala_spec": mala_spec, "bmm": bmm})

    # ---------------------------------------------------------------- 21
    grouped_stats = grouped_experts_phase({
        "reset_counts": reset_counts, "counts": counts,
        "path_counts": path_counts, "time_ms": time_ms, "compare": compare,
        "add_row": add_row, "rows": rows, "dev": dev})

    # ---------------------------------------------------------------- 15
    sources_of = {
        "matmul": ("src/repro_torch/kernels/csrc/gemm_tile.cuh",
                   "src/repro/kernels/matmul.py:57"),
        "matmul_bf16": ("src/repro_torch/kernels/csrc/gemm_sm90.cuh",
                        "src/repro/kernels/matmul.py:57"),
        "block_map_region": ("src/repro_torch/kernels/csrc/block_map.cuh",
                             "src/repro/kernels/generic.py:50"),
        "row_softmax": ("src/repro_torch/kernels/csrc/row_softmax.cu",
                        "src/repro/kernels/generic.py:50"),
        "spmv": ("src/repro_torch/kernels/csrc/spmv.cu",
                 "src/repro/kernels/spmv.py:121"),
        "spmm": ("src/repro_torch/kernels/csrc/spmm.cu",
                 "src/repro/kernels/spmm.py:57"),
        "page_gather": ("src/repro_torch/kernels/csrc/page_gather.cu",
                        "src/repro/kernels/paged_kv.py:139"),
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:39"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:100"),
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "src/repro/kernels/flash_attention.py:120"),
        "flash_attention_f32": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:120"),
        "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6.cu",
                       "src/repro/kernels/rwkv6.py:78"),
        "rglru_scan": ("src/repro_torch/kernels/csrc/rglru.cu",
                       "src/repro/kernels/rglru.py:69"),
        "batched_gemm_small": (
            "src/repro_torch/kernels/csrc/batched_gemm.cu",
            "src/repro/kernels/batched_gemm.py:73"),
        "batched_gemm_tiled": (
            "src/repro_torch/kernels/csrc/gemm_tile.cuh",
            "src/repro/kernels/batched_gemm.py:94"),
        "batched_gemm_tiled_bf16": (
            "src/repro_torch/kernels/csrc/gemm_sm90.cuh",
            "src/repro/kernels/batched_gemm.py:94"),
        "grouped_gate_up": (
            "src/repro_torch/kernels/csrc/grouped_gemm.cu",
            "none: the XLA einsums of src/repro/models/moe.py::expert_ffn"),
        "grouped_down": (
            "src/repro_torch/kernels/csrc/grouped_gemm.cu",
            "none: the XLA einsums of src/repro/models/moe.py::expert_ffn"),
    }
    kernels = []
    for name in wrappers:
        r = rows[name]
        b_ms, b_by = bound(r["bytes"], r["ops"], r["peak"])
        launches = sum(c[name][0] for c in path_counts.values())
        if launches == 0:
            fail(f"{name} was never launched on the main paths")
        kernels.append({
            "name": name, "route": "cuda", "source": sources_of[name][0],
            "replaces": sources_of[name][1], "launches": launches,
            "max_abs_err": worst[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r["library_ms"]})
    print(json.dumps({"block_ms": block_ms, "block_library_ms": block_lib_ms,
                      "block_device_ms": block_dev_ms,
                      "block_library_device_ms": block_lib_dev_ms,
                      "block_bf16_device_ms": block16_dev_ms,
                      "block_bf16_library_device_ms": block16_lib_dev_ms,
                      "block_gemms": gemm_stats,
                      "block_launches": mod.launch_count,
                      "demo_launches": demo_launches,
                      "build_s": build_s, "tokens": T_TOKENS,
                      "d_model": d, "d_ff": d_ff, "spmv": spmv_stats,
                      "spmm": spmm_stats, "paged": paged_stats,
                      "serve": serve_stats, "prefill_ms": prefill_ms,
                      "decode_step": step_stats,
                      "decode_step_launches": per_step,
                      "recurrent_kernels": recurrent_kernel_stats,
                      "flash_attention": flash_stats,
                      "decode_attention": decode_stats,
                      "rmsnorm": rms_stats, "row_softmax": softmax_stats,
                      "nests": nest_stats,
                      "serve_rwkv6_3b": rwkv_stats,
                      "serve_recurrentgemma_9b": rg_stats,
                      "batched": batched_stats, "resnet18": resnet_stats,
                      "mala": mala_stats, "training": train_stats,
                      "translate": translate_stats,
                      "families": families_stats,
                      "distribution": distribution_stats,
                      "verification": verification_stats,
                      "grouped_experts": grouped_stats,
                      "launches_by_path": {
                          p: {k: l for k, (l, _) in c.items() if l}
                          for p, c in path_counts.items()}}),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
