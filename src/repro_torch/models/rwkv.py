"""RWKV6 (Finch) block — the port of the reference's ``models/rwkv.py``:
data-dependent token shift (ddlerp), data-dependent per-channel decay,
the WKV scan (``kernels.ops.rwkv6``: the hand kernel on the card) and
channel mixing.

Decode keeps O(1) state per layer: the last hidden for each shift and
the WKV state (H, K, V).  The dtypes are the reference's: prefill hands
the scan w and u in the compute dtype, decode's one-step cell keeps
them in f32.  Activations are constrained at the reference's two places
(``dist.sharding.constrain``: the identity without a mesh), and its
prefill takes the decode state from the
scan's own final state, where the reference runs a second, plain scan.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain, constrain_batch, reshape
from repro_torch.kernels import ops as kops
from repro_torch.models.spec import Spec

_MIX_KEYS = ("w", "k", "v", "r", "g")


def time_mix_spec(cfg) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    rank = cfg.rwkv_lora_rank
    s = {
        # ddlerp: μ_x plus per-stream μ_c and a shared low-rank modulation
        "mu_x": Spec((d,), (None,), init="normal:0.5"),
        "lora_a": Spec((d, 5 * rank), ("embed", None), init="xavier"),
        "lora_b": Spec((5, rank, d), (None, None, "embed"), init="zeros"),
        # decay: w0 + low-rank data-dependent part
        "w0": Spec((d,), (None,), init="uniform_decay"),
        "w_lora_a": Spec((d, rank), ("embed", None), init="xavier"),
        "w_lora_b": Spec((rank, d), (None, "embed"), init="zeros"),
        "u": Spec((H, hd), (None, None), init="normal:0.1"),
        "wr": Spec((d, d), ("embed", "qkv"), init="xavier"),
        "wk": Spec((d, d), ("embed", "qkv"), init="xavier"),
        "wv": Spec((d, d), ("embed", "qkv"), init="xavier"),
        "wg": Spec((d, d), ("embed", "qkv"), init="xavier"),
        "wo": Spec((d, d), ("qkv", "embed"), init="xavier"),
        "ln_x": Spec((d,), (None,), init="ones"),
    }
    for key in _MIX_KEYS:
        s[f"mu_{key}"] = Spec((d,), (None,), init="normal:0.5")
    return s


def channel_mix_spec(cfg) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    return {
        "mu_k": Spec((d,), (None,), init="normal:0.5"),
        "mu_r": Spec((d,), (None,), init="normal:0.5"),
        "wk": Spec((d, dff), ("embed", "ffn"), init="xavier"),
        "wr": Spec((d, d), ("embed", None), init="xavier"),
        "wv": Spec((dff, d), ("ffn", "embed"), init="xavier"),
    }


def _shifted(x: torch.Tensor, shift_state: Optional[torch.Tensor]
             ) -> torch.Tensor:
    """x one step later in time: the carried last hidden (or zeros) first."""
    if shift_state is None:
        return F.pad(x, (0, 0, 1, 0))[:, :x.shape[1]]
    return torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)


def _ddlerp(p: dict, x: torch.Tensor, shifted: torch.Tensor) -> dict:
    """Data-dependent lerp (RWKV6 token shift) → the 5 mixed streams."""
    dt = x.dtype
    xx = shifted - x
    base = x + xx * p["mu_x"].to(dt)
    rank = p["lora_a"].shape[1] // 5
    lo = torch.tanh(base @ p["lora_a"].to(dt))            # (..., 5*rank)
    lo = reshape(lo, lo.shape[:-1] + (5, rank))
    mods = torch.einsum("...fr,frd->...fd", lo, p["lora_b"].to(dt))
    out = {}
    for i, key in enumerate(_MIX_KEYS):
        mix = p[f"mu_{key}"].to(dt) + mods[..., i, :]
        out[key] = x + xx * mix
    return out


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel data-dependent decay w ∈ (0,1), in f32."""
    dt = xw.dtype
    dyn = torch.tanh(xw @ p["w_lora_a"].to(dt)) @ p["w_lora_b"].to(dt)
    return torch.exp(-torch.exp(
        (p["w0"].float() - 5.0) + dyn.float()))


def _group_norm(x: torch.Tensor, scale: torch.Tensor, H: int
                ) -> torch.Tensor:
    """Per-head group norm of the WKV output (RWKV6's ln_x): population
    variance, eps 1e-5, as ``jnp.var``."""
    B, T, d = x.shape
    xh = reshape(x, B, T, H, d // H).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, unbiased=False, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + 1e-5)
    return (xh.reshape(B, T, d) * scale.float()).to(x.dtype)


def apply_time_mix(p: dict, x: torch.Tensor, cfg, *,
                   shift_state: Optional[torch.Tensor] = None,
                   wkv_state: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """x: (B, T, D).  Training: states None.  Decode: T == 1 with states.
    As in the reference, a call with more than one step starts the scan
    from zero whatever ``wkv_state`` holds."""
    B, T, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    dt = x.dtype
    mixed = _ddlerp(p, x, _shifted(x, shift_state))
    r = reshape(mixed["r"] @ p["wr"].to(dt), B, T, H, hd)
    k = reshape(mixed["k"] @ p["wk"].to(dt), B, T, H, hd)
    v = reshape(mixed["v"] @ p["wv"].to(dt), B, T, H, hd)
    g = F.silu(mixed["g"] @ p["wg"].to(dt))
    w = reshape(_decay(p, mixed["w"]), B, T, H, hd)
    if T == 1 and wkv_state is not None:
        # stateful single step (decode): the closed-form cell update
        y, new_state = _wkv_cell(r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                                 p["u"].float(), wkv_state)
        y = y[:, None]
    else:
        y, final = kops.rwkv6(r, k, v, w.to(dt), p["u"].to(dt))
        new_state = final if return_state else None
    y = _group_norm(y.reshape(B, T, d), p["ln_x"], H) * g
    out = constrain_batch(constrain(y, "batch", None, "qkv") @
                          p["wo"].to(dt))
    if return_state or wkv_state is not None:
        return out, (x[:, -1, :], new_state)
    return out


def _wkv_cell(r, k, v, w, u, state):
    """One recurrence step.  r/k/w: (B,H,K); v: (B,H,V); state (B,H,K,V)."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rf, state + u[None, :, :, None] * kv)
    new_state = wf[..., :, None] * state + kv
    B, H, V = y.shape
    return y.reshape(B, H * V).to(v.dtype), new_state


def apply_channel_mix(p: dict, x: torch.Tensor, cfg, *,
                      shift_state: Optional[torch.Tensor] = None,
                      return_state: bool = False):
    dt = x.dtype
    xx = _shifted(x, shift_state) - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)
    k = torch.square(F.relu(xk @ p["wk"].to(dt)))
    k = constrain(k, "batch", None, "ffn")
    out = torch.sigmoid(xr @ p["wr"].to(dt)) * \
        constrain_batch(k @ p["wv"].to(dt))
    if return_state or shift_state is not None:
        return out, x[:, -1, :]
    return out
