"""The port's chunked attention (``repro_torch.kernels.chunked``), held to
the JAX reference's ``repro.kernels.chunked`` on the CPU.

At the shapes of ``tests/test_kernels.py::test_chunked_attention_matches_ref``
(2 × 4 query / 2 KV heads × 300 positions × 32, q_chunk 128, kv_chunk
64: ragged tails in both, GQA grouped), with causal, windowed,
non-causal and softcapped cases: ``chunked_attention`` and
``flash_chunked_attention`` within 1e-5 of the reference's output, and
their gradients (autograd; the flash variant's recomputing backward)
within 1e-5 of ``jax.grad``'s, each leaf to its largest entry.  Then
``kernels/ops.py::attention`` on the ``torch`` target: above 2048
positions it takes the chunked route (and equals the reference's dense
``ref.attention``), at 2048 the dense block; the ``cuda`` target sends
every length to the flash kernel's wrapper.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import chunked as jchunked  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.options import CompileOptions  # noqa: E402
from repro_torch.kernels import chunked as tchunked  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

CASES = {"causal": {"causal": True},
         "window": {"causal": True, "window": 64},
         "full": {"causal": False},
         "softcap": {"causal": True, "logit_softcap": 5.0}}
FNS = ("chunked_attention", "flash_chunked_attention")
CHUNKS = {"q_chunk": 128, "kv_chunk": 64}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 4, 300, 32), dtype=np.float32)
    k = rng.standard_normal((2, 2, 300, 32), dtype=np.float32)
    v = rng.standard_normal((2, 2, 300, 32), dtype=np.float32)
    g = rng.standard_normal((2, 4, 300, 32), dtype=np.float32)
    return q, k, v, g


def _near(got, want, tol, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=str(what))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fn", FNS)
def test_chunked_attention_and_grads_match_reference(inputs, fn, case):
    q, k, v, g = inputs
    kw = dict(CASES[case], **CHUNKS)
    jf = getattr(jchunked, fn)

    def jloss(a, b, c):
        out = jf(a, b, c, **kw)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = getattr(tchunked, fn)(tq, tk, tv, **kw)
    _near(out.detach().numpy(), jout, 1e-5, (fn, case, "out"))
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                (tq, tk, tv))
    for name, got, want in zip("qkv", grads, jgrads):
        _near(got.numpy(), want, 1e-5, (fn, case, "d" + name))


def test_flash_chunked_saves_only_its_inputs_output_and_lse(inputs):
    """The flash variant keeps (q, k, v, out, lse) for its backward and
    no chunk pair's probabilities."""
    q, k, v, _ = inputs
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tchunked.flash_chunked_attention(tq, tk, tv, **CHUNKS)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        (2, 4, 300, 32), (2, 2, 300, 32), (2, 2, 300, 32),
        (2, 4, 300, 32), (2, 2, 2, 300)]


@pytest.fixture(scope="module")
def long_inputs():
    rng = np.random.default_rng(1)
    return {s: tuple(rng.standard_normal(shape, dtype=np.float32)
                     for shape in ((1, 2, s, 16), (1, 1, s, 16),
                                   (1, 1, s, 16)))
            for s in (2048, 2049)}


@pytest.mark.parametrize("target", ["torch", "cuda"])
@pytest.mark.parametrize("s", [2048, 2049])
def test_attention_routes_long_sequences_to_chunked(long_inputs,
                                                    monkeypatch, target, s):
    calls = []
    real = tchunked.flash_chunked_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tchunked, "flash_chunked_attention", counted)
    q, k, v = long_inputs[s]
    plain = tfa.flash_attention.plain_calls
    out = kops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         causal=True,
                         options=CompileOptions(target=target, device="cpu"))
    chunked = target == "torch" and s > kops.CHUNKED_ATTN_THRESHOLD
    assert len(calls) == int(chunked)
    # the cuda target goes to the flash wrapper, whose plain version runs
    # on the CPU
    assert tfa.flash_attention.plain_calls - plain == int(target == "cuda")
    want = jref.attention(q, k, v, causal=True)
    _near(out.numpy(), want, 1e-5, (target, s))
