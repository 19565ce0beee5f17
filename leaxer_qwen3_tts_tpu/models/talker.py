"""The talker: 28-layer GQA codec-token LM (prefill + single-step decode).

Replaces the reference's talker_prefill.onnx / talker_decode.onnx pair
(tts_onnx.cpp:615-732) with one JAX transformer sharing a device-resident KV
cache.  ``last_hidden`` (post-final-norm hidden of the last real position) feeds
the code predictor, matching the reference's last_hidden output contract.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import TalkerConfig
from ..ops.quant import dense
from .layers import KVCache, init_kv_cache, init_transformer_params, transformer_forward


def init_talker_params(cfg: TalkerConfig, key: jax.Array) -> dict:
    k1, k2 = jax.random.split(key)
    h = cfg.hidden_size
    dt = cfg.transformer.jnp_dtype
    scale = 1.0 / jnp.sqrt(h)
    return {
        "transformer": init_transformer_params(cfg.transformer, k1),
        "lm_head": (jax.random.normal(k2, (h, cfg.codec_vocab_size), jnp.float32) * scale).astype(
            dt
        ),
    }


def talker_init_cache(cfg: TalkerConfig, batch: int, max_len: int) -> KVCache:
    return init_kv_cache(cfg.transformer, batch, max_len)


def talker_prefill(
    cfg: TalkerConfig,
    params: dict,
    prompt_embeds: jax.Array,  # [B, P, H] (right-padded)
    prompt_len: jax.Array,  # [B] int32 true lengths
    cache: KVCache,
) -> Tuple[jax.Array, jax.Array, KVCache, jax.Array]:
    """Prompt pass.

    Returns (last_logits [B, V] f32, last_hidden [B, H], cache, valid_mask [B, T]).
    """
    B, P, H = prompt_embeds.shape
    positions = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32), (B, P))
    query_valid = positions < prompt_len[:, None]
    valid_mask = jnp.zeros((B, cache.max_len), bool)

    hidden, cache, valid_mask = transformer_forward(
        cfg.transformer,
        params["transformer"],
        prompt_embeds,
        positions,
        cache,
        valid_mask,
        query_valid=query_valid,
    )
    # Gather hidden at the last real position per sequence, project only that row
    # (the reference computes logits for every prompt position and uses only the
    # last, tts_onnx.cpp:796-798 — projecting one row is strictly cheaper).
    idx = jnp.clip(prompt_len - 1, 0, P - 1)
    last_hidden = jnp.take_along_axis(hidden, idx[:, None, None].repeat(H, axis=2), axis=1)[:, 0]
    last_logits = dense(last_hidden, params["lm_head"])
    return last_logits, last_hidden, cache, valid_mask


def talker_prefill_all_logits(
    cfg: TalkerConfig,
    params: dict,
    prompt_embeds: jax.Array,
    prompt_len: jax.Array,
    cache: KVCache,
) -> Tuple[jax.Array, jax.Array, KVCache]:
    """Like talker_prefill but returns logits for every prompt position
    ([B, P, V] f32) — parity-testing / scoring path."""
    B, P, H = prompt_embeds.shape
    positions = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32), (B, P))
    query_valid = positions < prompt_len[:, None]
    valid_mask = jnp.zeros((B, cache.max_len), bool)
    hidden, cache, valid_mask = transformer_forward(
        cfg.transformer,
        params["transformer"],
        prompt_embeds,
        positions,
        cache,
        valid_mask,
        query_valid=query_valid,
    )
    logits = dense(hidden, params["lm_head"])
    return logits, hidden, cache, valid_mask


def talker_decode_step(
    cfg: TalkerConfig,
    params: dict,
    embed: jax.Array,  # [B, H] — the summed next-input embedding
    position: jax.Array,  # [B] int32 RoPE position of this token
    cache: KVCache,
    valid_mask: jax.Array,  # [B, T] bool
    uniform_fill: bool = True,
) -> Tuple[jax.Array, jax.Array, KVCache, jax.Array]:
    """One decode step.  Returns (logits [B, V] f32, hidden [B, H], cache, valid_mask).

    ``uniform_fill=False`` (continuous serving pool) switches the cache write
    to per-sequence offsets; the default keeps the cheap lockstep path."""
    hidden, cache, valid_mask = transformer_forward(
        cfg.transformer,
        params["transformer"],
        embed[:, None, :],
        position[:, None],
        cache,
        valid_mask,
        uniform_fill=uniform_fill,
    )
    hidden = hidden[:, 0]
    logits = dense(hidden, params["lm_head"])
    return logits, hidden, cache, valid_mask
