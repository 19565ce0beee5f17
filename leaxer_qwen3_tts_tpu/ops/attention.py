"""Grouped-query attention over the static KV cache, in plain XLA.

K/V are HEAD-MAJOR ([B, Nk, T, D]) to match the KV-cache layout
(models/layers.py KVCache): the decode-step scores/output contractions are
then clean batched GEMMs over (B, Nk) with no physical transposes of the
cache.

int8 KV cache support: when per-slot scales are given (k/v stored int8), the
dequant is applied in the SCORE domain — scores[..., t] *= k_scale[t] after
the Q.K dot, and softmax weights[..., t] *= v_scale[t] before the weights.V
dot.  That is exact (scales are per-slot scalars w.r.t. the contraction dims)
and costs O(T) multiplies per head instead of O(T*d) for materializing a
dequantized cache.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

NEG_INF = -1e30  # large-but-finite: keeps fully-masked rows NaN-free after softmax


def attend_xla(
    q: jax.Array,  # [B, S, Nq, D]
    k: jax.Array,  # [B, Nk, T, D] head-major (bf16/f32, or int8 + k_scale)
    v: jax.Array,  # [B, Nk, T, D]
    mask: jax.Array,  # [B, S, T] bool (True = attend)
    k_scale: Optional[jax.Array] = None,  # f32 [B, Nk, T]
    v_scale: Optional[jax.Array] = None,
) -> jax.Array:
    """Grouped-query attention; returns [B, S, Nq, D] in q.dtype."""
    B, S, nq, d = q.shape
    nk, T = k.shape[1], k.shape[2]
    g = nq // nk

    # group q by kv head: [B, S, Nq, D] -> [B, Nk, g*S, D]
    qh = q.reshape(B, S, nk, g, d)
    qh = jnp.transpose(qh, (0, 2, 3, 1, 4)).reshape(B, nk, g * S, d)

    compute_dt = k.dtype if k.dtype != jnp.int8 else jnp.bfloat16
    if q.dtype == jnp.float32 and k.dtype == jnp.int8:
        compute_dt = jnp.float32  # f32 models (tests): keep exact parity math
    scores = jax.lax.dot_general(
        qh.astype(compute_dt), k.astype(compute_dt),
        (((3,), (3,)), ((0, 1), (0, 1))), preferred_element_type=jnp.float32,
    )  # [B, Nk, g*S, T]
    scores = scores * (1.0 / jnp.sqrt(d).astype(jnp.float32))
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, :]
    m = jnp.broadcast_to(mask[:, None, None, :, :], (B, nk, g, S, T)).reshape(
        B, nk, g * S, T
    )
    scores = jnp.where(m, scores, NEG_INF)
    weights = jax.nn.softmax(scores, axis=-1)
    if v_scale is not None:
        weights = weights * v_scale[:, :, None, :]

    out = jax.lax.dot_general(
        weights.astype(compute_dt), v.astype(compute_dt),
        (((3,), (2,)), ((0, 1), (0, 1))),
    )  # [B, Nk, g*S, D]
    out = out.reshape(B, nk, g, S, d)
    out = jnp.transpose(out, (0, 3, 1, 2, 4)).reshape(B, S, nq, d)
    return out.astype(q.dtype)

