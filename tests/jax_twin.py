"""The port's configs as the JAX package computes them, for the tests
that hold the port to the JAX package.

The port's grok-1-314b is the published model: post-norms, the
embedding and output multipliers, a tied head, RMSNorm's ε of 1e-5,
the top-2 gates as the softmax gave them and no token dropped, and the
logit cap in its decode steps too.  The JAX package's grok has none of
these, and its decode attention takes no cap.  ``twin`` turns those
parts of the port's config off, so that both packages compute the same
model; every other config comes back as it is.
"""
import dataclasses

# grok-1's published parts, each at what the JAX package does
JAX_GROK = dict(norm_eps=1e-6, post_norms=False, embed_scale=1.0,
                logit_scale=1.0, moe_renormalize=True, moe_dropless=False,
                tie_embeddings=False)
# the port's config fields that the JAX package's config has not
PORT_ONLY = ("norm_eps", "post_norms", "embed_scale", "logit_scale",
             "moe_renormalize", "moe_dropless")


def twin(tcfg, *, cap: bool = True):
    """The port's config ``tcfg`` with grok-1's published parts off and,
    with ``cap=False``, the logit cap off (as the JAX package's decode
    has it: then turn it off in the JAX package's config too)."""
    if tcfg.name.startswith("grok-1-314b"):
        tcfg = dataclasses.replace(tcfg, **JAX_GROK)
    if not cap:
        tcfg = dataclasses.replace(tcfg, attn_logit_softcap=None)
    return tcfg


def uncapped(cfg):
    """A config (either package's) with no logit cap."""
    return dataclasses.replace(cfg, attn_logit_softcap=None)


def shared_fields(tcfg) -> dict:
    """The port config's fields that the JAX package's config has too."""
    return {k: v for k, v in dataclasses.asdict(tcfg).items()
            if k not in PORT_ONLY}
