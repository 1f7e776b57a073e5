"""Kernel wrappers + registry registrations (the Kokkos Kernels surface).

Each ``kk.*`` op ported so far gets two implementations (the
``kokkos.page_*`` ops register in ``paged_kv``, imported here):

* ``torch`` — the plain version from ``ref.py`` (the "vendor library"
              path: ``torch.matmul`` is cuBLAS on the card);
* ``cuda``  — the hand-written kernel, differentiable through a
              ``torch.autograd.Function`` whose forward is the kernel and
              whose backward is derived from the plain version.

``kk.conv2d`` is the exception: the reference registers only its library
path, so it has a ``torch`` entry alone and the ``cuda`` chain serves it
from there (cuDNN).

Model code calls the model-facing wrappers (``attention``,
``decode_attention``, ``rmsnorm``, ``rwkv6``, ``rglru``), which ask the
ambient ``CompileOptions``' backend whether it wants kernels, as the
reference does.  The scans return their final state beside y (the
reference's wrappers return y alone and its models run a second, plain
scan for the state).  As in the reference, attention on the library
path above ``CHUNKED_ATTN_THRESHOLD`` positions goes to
``kernels/chunked.py`` (online softmax over chunk pairs, the flash
backward), not to one dense softmax block.

Under a mesh (``dist.sharding``) these wrappers may receive DTensors.
The plain versions run on them through DTensor's own sharding
propagation.  A kernel runs on whole operands: a DTensor that every rank
holds whole (``Replicate()``, or ``Shard`` over mesh dims of size 1, as
on one card) runs the kernel on its ``to_local()`` (differentiable) and
the result is wrapped back with the operand's placements; an operand
truly sharded (a ``Shard`` over a mesh dim of size > 1) raises
``NotImplementedError`` naming the kernel — sharded kernels wait for a
multi-card slice, and nothing switches quietly to the plain version.
The scans' plain versions are Python loops over time, which DTensor
would dispatch step by step; every (batch row, head or channel) runs
its own recurrence, so under DTensors they run on local shards of the
batch (:func:`_plain_scan`: heads and channels replicated first).

The sparse ``kk.spmv`` / ``kk.spmm`` take the composite value
``sparse.pack`` made (a ``CsrMatrix``) and skip the autograd wrapper, as
the reference does.  The reference's ``pallas`` entries quietly ran the
library when a CSR operand came without ``max_nnz_row`` (its ELL width
had to be static under ``jax.jit``); the ``cuda`` kernels read CSR, so on
the card they always launch.  The other ``kk.*`` ops of the reference
register here with their kernels, slice by slice.
"""
from __future__ import annotations

import functools
import sys
from typing import Optional

import torch

from repro_torch.core import refs
from repro_torch.core.options import CompileOptions, current_options
from repro_torch.core.registry import register
from repro_torch.kernels import batched_gemm as _bg
from repro_torch.kernels import chunked as _chunked
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import paged_kv as _pk
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import rwkv6 as _rw
from repro_torch.kernels import spmm as _spmm
from repro_torch.kernels import spmv as _sp


# ---------------------------------------------------------------------------
# autograd plumbing: kernel forward, plain-version backward
# ---------------------------------------------------------------------------

class _Kernelized(torch.autograd.Function):
    """Forward runs ``kernel``; backward differentiates ``plain`` at the
    saved inputs (a kernelized backward is later work, as in the
    reference).  An input may be None (an absent initial state), and the
    output a tuple (a scan's y and final state)."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return kernel(*args)

    @staticmethod
    def backward(ctx, *grads):
        args = [None if a is None else a.detach().requires_grad_(need)
                for a, need in zip(ctx.saved_tensors,
                                   ctx.needs_input_grad[2:])]
        wanted = [a for a in args if a is not None and a.requires_grad]
        with torch.enable_grad():
            out = ctx.plain(*args)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        grads_in = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True))
        return (None, None, *(next(grads_in) if a is not None and
                              a.requires_grad else None for a in args))


# ---------------------------------------------------------------------------
# kk.gemm
# ---------------------------------------------------------------------------

@register("kk.gemm", "torch")
def gemm_torch(a, b, *, tiling=None):
    return ref.matmul(a, b)


@register("kk.gemm", "cuda")
def gemm_cuda(a, b, *, tiling=None):
    return _Kernelized.apply(functools.partial(_mm.matmul, tiling=tiling),
                             ref.matmul, a, b)


# ---------------------------------------------------------------------------
# kk.gemv — a gemv is a degenerate gemm: x becomes a one-column B
# ---------------------------------------------------------------------------

@register("kk.gemv", "torch")
def gemv_torch(a, x, *, tiling=None):
    return ref.gemv(a, x)


def _gemv_kernel(a, x):
    return _mm.matmul(a, x[:, None])[:, 0]


@register("kk.gemv", "cuda")
def gemv_cuda(a, x, *, tiling=None):
    return _Kernelized.apply(_gemv_kernel, ref.gemv, a, x)


# ---------------------------------------------------------------------------
# kk.batched_gemm
# ---------------------------------------------------------------------------

@register("kk.batched_gemm", "torch")
def batched_gemm_torch(a, b, *, tiling=None):
    return ref.batched_gemm(a, b)


@register("kk.batched_gemm", "cuda")
def batched_gemm_cuda(a, b, *, tiling=None):
    return _Kernelized.apply(
        functools.partial(_bg.batched_gemm, tiling=tiling),
        ref.batched_gemm, a, b)


# ---------------------------------------------------------------------------
# kk.conv2d — the library's (cuDNN on the card); the reference registers
# no Pallas kernel for it, so the cuda chain falls back to this one
# ---------------------------------------------------------------------------

@register("kk.conv2d", "torch")
def conv2d_torch(x, w, *, stride=(1, 1), padding="SAME", tiling=None):
    return refs.conv2d(x, w, stride, padding)


# ---------------------------------------------------------------------------
# kk.spmv / kk.spmm — the operand is the composite sparse value
# ---------------------------------------------------------------------------

@register("kk.spmv", "torch")
def spmv_torch(a, x, *, tiling=None, max_nnz_row=None):
    return _sp.spmv_reference(a, x)


@register("kk.spmv", "cuda")
def spmv_cuda(a, x, *, tiling=None, max_nnz_row=None):
    return _sp.spmv(a, x, tiling=tiling)


@register("kk.spmm", "torch")
def spmm_torch(a, b, *, tiling=None, max_nnz_row=None):
    return _sp.spmm_reference(a, b)


@register("kk.spmm", "cuda")
def spmm_cuda(a, b, *, tiling=None, max_nnz_row=None):
    return _spmm.spmm_sparse(a, b, tiling=tiling)


# ---------------------------------------------------------------------------
# model-facing wrappers (options-driven dispatch)
# ---------------------------------------------------------------------------

def _use_kernels(options: CompileOptions) -> bool:
    """Backend-policy query: hand-written kernels or the plain versions?
    (``cuda`` → always kernels, which take their plain version only for
    CPU tensors; ``auto`` → kernels iff the options resolve to the card;
    library and loop backends → the plain versions.)"""
    return options.backend().wants_kernels(options)


def _dtensor_type():
    """DTensor's class, or None while ``torch.distributed.tensor`` was
    never imported (then no DTensor can exist, and nothing is loaded)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def _whole_on_every_rank(name: str, t) -> None:
    for i, pl in enumerate(t.placements):
        if not pl.is_replicate() and t.device_mesh.size(i) > 1:
            raise NotImplementedError(
                f"{name}: an operand of shape {tuple(t.shape)} is {pl} over "
                f"mesh dim {t.device_mesh.mesh_dim_names[i]!r} of size "
                f"{t.device_mesh.size(i)}; the kernel runs on whole "
                "operands (sharded kernels wait for a multi-card slice)")


def _kernel_call(name: str, kernel, plain, *args):
    """``_Kernelized.apply(kernel, plain, *args)``.  DTensor operands,
    each whole on every rank, run on their local tensors; an output
    shaped like the first DTensor operand takes its placements (a
    ``Partial`` of a size-1 dim read as ``Replicate``), any other
    output is replicated."""
    DT = _dtensor_type()
    dts = [a for a in args if DT is not None and isinstance(a, DT)]
    if not dts:
        return _Kernelized.apply(kernel, plain, *args)
    from torch.distributed.tensor import Replicate
    for t in dts:
        _whole_on_every_rank(name, t)
    first = dts[0]
    mesh = first.device_mesh
    like = tuple(pl if pl.is_shard() else Replicate()
                 for pl in first.placements)
    out = _Kernelized.apply(kernel, plain, *(a.to_local() if isinstance(
        a, DT) else a for a in args))

    def wrap(o):
        pl = like if o.shape == first.shape else \
            (Replicate(),) * mesh.ndim
        return DT.from_local(o, mesh, pl, run_check=False)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def _plain_scan(plain, batched, *args):
    """``plain(*args)`` for a scan whose rows are independent: with any
    DTensor operand, each operand flagged in ``batched`` (dim 0 is the
    batch) is redistributed to the first DTensor's batch sharding (its
    ``Shard(0)`` mesh dims, every other mesh dim replicated), the rest
    replicated; ``plain`` runs on the local shards and its outputs (each
    batch-first) come back with that batch sharding."""
    DT = _dtensor_type()
    dts = [a for a in args if DT is not None and isinstance(a, DT)]
    if not dts:
        return plain(*args)
    from torch.distributed.tensor import Replicate, Shard
    mesh = dts[0].device_mesh
    rep = (Replicate(),) * mesh.ndim
    rows = tuple(Shard(0) if pl == Shard(0) else Replicate()
                 for pl in dts[0].placements)

    def local(a, is_batched):
        if a is None:
            return None
        if not isinstance(a, DT):
            a = DT.from_local(a, mesh, rep, run_check=False)
        return a.redistribute(mesh, rows if is_batched else rep).to_local()
    out = plain(*(local(a, b) for a, b in zip(args, batched)))
    return tuple(DT.from_local(o, mesh, rows, run_check=False) for o in out)


CHUNKED_ATTN_THRESHOLD = 2048     # longest S computed as one dense block


def attention(q, k, v, *, causal=True, window=None, scale=None,
              logit_softcap=None, options: Optional[CompileOptions] = None):
    """GQA attention: the flash kernel where the backend wants kernels;
    else one dense plain softmax block up to ``CHUNKED_ATTN_THRESHOLD``
    positions and the chunked online-softmax form above it (O(chunk²)
    live memory, where a dense (B, H, S, S) block grows as S²).  The
    reference nests its chunked form under ``jax.checkpoint`` so that
    its scans stack no residuals; the autograd function saves only
    (q, k, v, out, lse) already."""
    options = options or current_options()
    kw = {"causal": causal, "window": window, "scale": scale,
          "logit_softcap": logit_softcap}
    if _use_kernels(options):
        return _kernel_call("flash_attention",
                            functools.partial(_fa.flash_attention, **kw),
                            functools.partial(ref.attention, **kw), q, k, v)
    if max(q.shape[2], k.shape[2]) > CHUNKED_ATTN_THRESHOLD:
        return _chunked.flash_chunked_attention(q, k, v, **kw)
    return ref.attention(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, lengths, *, window=None,
                     scale=None, options: Optional[CompileOptions] = None):
    """One-token cached attention: the decode kernel where the backend
    wants kernels, else the plain version."""
    options = options or current_options()
    kw = {"window": window, "scale": scale}
    if _use_kernels(options):
        return _kernel_call(
            "decode_attention",
            functools.partial(_da.decode_attention, **kw),
            functools.partial(ref.decode_attention, **kw),
            q, k_cache, v_cache, lengths)
    return ref.decode_attention(q, k_cache, v_cache, lengths, **kw)


def rmsnorm(x, weight, *, eps=1e-6,
            options: Optional[CompileOptions] = None):
    options = options or current_options()
    if _use_kernels(options):
        return _kernel_call("rmsnorm", functools.partial(_rn.rmsnorm, eps=eps),
                            functools.partial(ref.rmsnorm, eps=eps),
                            x, weight)
    return ref.rmsnorm(x, weight, eps=eps)


def rwkv6(r, k, v, w, u, *, state=None,
          options: Optional[CompileOptions] = None):
    """The WKV6 scan → (y, final state): the kernel where the backend
    wants kernels, else the plain version."""
    options = options or current_options()
    if _use_kernels(options):
        return _kernel_call("rwkv6_scan", _rw.rwkv6_scan, ref.rwkv6_scan,
                            r, k, v, w, u, state)
    return _plain_scan(ref.rwkv6_scan, (True, True, True, True, False, True),
                       r, k, v, w, u, state)


def rglru(x, r_gate, i_gate, log_a_param, *, state=None,
          options: Optional[CompileOptions] = None):
    """The RG-LRU scan → (y, final h): the kernel where the backend wants
    kernels, else the plain version."""
    options = options or current_options()
    if _use_kernels(options):
        return _kernel_call("rglru_scan", _rg.rglru_scan, ref.rglru_scan,
                            x, r_gate, i_gate, log_a_param, state)
    return _plain_scan(ref.rglru_scan, (True, True, True, False, True),
                       x, r_gate, i_gate, log_a_param, state)


# registry entries for the model-facing ops too (pipeline completeness)
register("kk.attention", "torch")(
    lambda q, k, v, *, tiling=None, **kw: ref.attention(q, k, v, **kw))
register("kk.attention", "cuda")(
    lambda q, k, v, *, tiling=None, **kw: _fa.flash_attention(q, k, v, **kw))
register("kk.rwkv6_scan", "torch")(
    lambda r, k, v, w, u, *, tiling=None: ref.rwkv6_scan(r, k, v, w, u)[0])
register("kk.rwkv6_scan", "cuda")(
    lambda r, k, v, w, u, *, tiling=None: _rw.rwkv6_scan(r, k, v, w, u)[0])
register("kk.rglru_scan", "torch")(
    lambda x, r, i, la, *, tiling=None: ref.rglru_scan(x, r, i, la)[0])
register("kk.rglru_scan", "cuda")(
    lambda x, r, i, la, *, tiling=None: _rg.rglru_scan(x, r, i, la)[0])


# ---------------------------------------------------------------------------
# ahead-of-time builds
# ---------------------------------------------------------------------------

def serving_kernel_sources() -> list:
    """The kernel libraries the serving paths launch besides the page
    gather: decode attention, RMSNorm, flash attention (f32 and bf16)
    and the two recurrent scans."""
    return [_da.decode_attention_kernel(), _rn.rmsnorm_kernel(),
            *_fa.kernel_sources(), _rw.rwkv6_kernel(), _rg.rglru_kernel()]


def kernel_sources(graph) -> list:
    """The kernel libraries a graph lowered for the ``cuda`` target
    launches, so a caller can build them together (``_build.build_all``)
    before the first call instead of one nvcc at a time."""
    from repro_torch.core.ir import KOKKOS_PARALLEL_OPS
    from repro_torch.kernels import generic
    out = []
    for op in graph.ops:
        if op.opname in ("kk.gemm", "kk.gemv"):
            out.append(_mm.matmul_kernel())
        elif op.opname == "kk.batched_gemm":
            (m, _), (_, n) = (o.type.shape[-2:] for o in op.operands)
            small, _, _, bk, _ = _bg.check_tiling(op.attrs["tiling"], m, n)
            out.append(_bg.batched_gemm_kernel(small, bk if small else 0))
        elif op.opname == "kk.spmv":
            out.append(_sp.spmv_kernel())
        elif op.opname == "kk.spmm":
            out.append(_spmm.spmm_kernel())
        elif op.opname == "kokkos.page_gather":
            out.append(_pk.page_gather_kernel())
        elif op.opname == "kk.attention":
            out.extend(_fa.kernel_sources())
        elif op.opname in KOKKOS_PARALLEL_OPS and \
                not op.attrs.get("collapse"):
            if op.attrs["kind"] == "reduce":
                out.append(generic.softmax_kernel())
            else:
                region = (op.regions[0] if op.regions
                          else generic.one_op_region(op))
                out.append(generic.region_kernel(
                    region, [o.type.dtype for o in op.operands],
                    op.results[0].type.dtype))
    return out
