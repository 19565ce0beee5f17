"""Code predictor: the MTP head emitting sub-codebooks 1..15 per frame.

Replaces the reference's 31-session-calls-per-frame inner loop (code_predictor +
code_predictor_embed, tts_onnx.cpp:851-872) with ONE jitted ``lax.scan`` over the
15 steps, running a small incremental-KV transformer entirely on device.

Contract (mirrors the reference exactly):
  * the input sequence starts [talker_last_hidden, codec_embed(code0)]
  * step j consumes the growing sequence and emits 2048-way logits from a
    step-indexed output head (the reference's ``generation_step`` input)
  * the token sampled at step j is embedded with the step-j table
    (code_predictor_embed.onnx) and appended for step j+1
  * the sum of all 15 sub-embeddings feeds the next talker input
    (reference tts_onnx.cpp:823-842)
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import CodePredictorConfig
from ..ops.quant import dense, index_weight
from ..runtime.sampling import split_keys
from .layers import (
    KVCache,
    init_kv_cache,
    init_transformer_params,
    transformer_forward,
)


def init_code_predictor_params(cfg: CodePredictorConfig, key: jax.Array) -> dict:
    k1, k2, k3 = jax.random.split(key, 3)
    t = cfg.transformer
    h = t.hidden_size
    dt = t.jnp_dtype
    scale = 1.0 / jnp.sqrt(h)
    if cfg.head_mode == "shared":
        # fallback topology (docs/FALSIFIABILITY.md §2): one shared 2048-way
        # head; the generation step enters as a learned additive embedding
        # on the transformer input producing that step's logits
        return {
            "transformer": init_transformer_params(t, k1),
            "head": (
                jax.random.normal(k2, (h, cfg.subcode_vocab_size), jnp.float32)
                * scale
            ).astype(dt),
            "step_embed": (
                jax.random.normal(k3, (cfg.num_steps, h), jnp.float32) * 0.02
            ).astype(dt),
        }
    return {
        "transformer": init_transformer_params(t, k1),
        # one 2048-way output head per generation step
        "heads": (
            jax.random.normal(k2, (cfg.num_steps, h, cfg.subcode_vocab_size), jnp.float32) * scale
        ).astype(dt),
    }


def _head_fn(cfg: CodePredictorConfig, params: dict):
    """(h [B,H], j) -> logits [B, V] under either head topology."""
    if cfg.head_mode == "shared":
        w = params["head"]
        return lambda h, j: dense(h, w)
    heads = params["heads"]
    return lambda h, j: dense(h, index_weight(heads, j))


def _step_cond(cfg: CodePredictorConfig, params: dict):
    """Additive step conditioning of the transformer input (shared-head
    topology only).  Returns (c0_add, cond) where ``c0_add`` is added to the
    code0 prefix token (whose hidden produces step-0 logits) and
    ``cond(emb, j)`` conditions the embedding of the token sampled at step j
    (whose hidden produces step-(j+1) logits).  The raw table embedding —
    NOT the conditioned one — still feeds ``sub_embed_sum`` (the talker
    next-input contract, reference tts_onnx.cpp:823-842)."""
    if cfg.head_mode == "shared":
        se = params["step_embed"]
        n = se.shape[0]

        def cond(emb, j):
            # j+1 clamped: the final step's embedding is never fed back
            row = lax.dynamic_index_in_dim(
                se, jnp.minimum(j + 1, n - 1), axis=0, keepdims=False
            )
            return emb + row.astype(emb.dtype)

        return se[0].astype(jnp.float32), cond
    return jnp.float32(0.0), lambda emb, j: emb


def predict_subcodes(
    cfg: CodePredictorConfig,
    params: dict,
    pred_embed_tables: jax.Array,  # [num_steps, subcode_vocab, H]
    last_hidden: jax.Array,  # [B, H] — talker hidden for this frame
    code0_embed: jax.Array,  # [B, H] — codec_embed(code0)
    key: jax.Array,
    sample_fn: Callable[[jax.Array, jax.Array], jax.Array],  # (key, logits[B,V]) -> [B] int32
) -> Tuple[jax.Array, jax.Array]:
    """Runs the 15-step MTP loop for one frame.

    Returns (subcodes [B, 15] int32, sub_embed_sum [B, H]) where sub_embed_sum is
    the sum over steps of table[j][subcode_j] — the talker's next-input term.
    """
    if cfg.impl == "dense":
        return predict_subcodes_dense(
            cfg, params, pred_embed_tables, last_hidden, code0_embed, key, sample_fn
        )
    subcodes, sub_sum, _ = mtp_chain(
        cfg, params, pred_embed_tables, last_hidden, code0_embed, key, sample_fn
    )
    return subcodes, sub_sum


def mtp_chain(
    cfg: CodePredictorConfig,
    params: dict,
    pred_embed_tables: jax.Array,
    last_hidden: jax.Array,
    code0_embed: jax.Array,
    key: jax.Array,
    sample_fn: Callable[[jax.Array, jax.Array], jax.Array],
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """The cached (incremental-KV) chain behind ``impl="cached"``.

    Returns (subcodes [B, n], sub_embed_sum [B, H], logits [B, n, V] f32);
    the per-step logits are what the reference comparison reads (unused
    outputs of the scan are dropped when compiled)."""
    t = cfg.transformer
    B, H = last_hidden.shape
    n = cfg.num_steps

    cache = init_kv_cache(t, B, cfg.max_seq_len)
    valid = jnp.zeros((B, cfg.max_seq_len), bool)

    head_logits = _head_fn(cfg, params)
    c0_add, cond = _step_cond(cfg, params)

    # Prime with the 2-token prefix [last_hidden, code0_embed]
    prefix = jnp.stack(
        [
            last_hidden.astype(t.jnp_dtype),
            (code0_embed + c0_add).astype(t.jnp_dtype),
        ],
        axis=1,
    )
    positions = jnp.broadcast_to(jnp.arange(2, dtype=jnp.int32), (B, 2))
    hidden, cache, valid = transformer_forward(
        t, params["transformer"], prefix, positions, cache, valid
    )
    h_last = hidden[:, 1]  # hidden at the code0 position -> step-0 logits

    def step(carry, j):
        h_prev, cache, valid, key = carry
        key, sub = split_keys(key, 2)
        logits_j = head_logits(h_prev, j)
        subcode_j = sample_fn(sub, logits_j)  # [B]
        table = lax.dynamic_index_in_dim(pred_embed_tables, j, axis=0, keepdims=False)
        emb_j = jnp.take(table, subcode_j, axis=0)  # [B, H]

        # feed emb_j for the next step's logits (wasted on the final step only if
        # we ran it; we instead stop the scan one early and handle j = n-1 below)
        pos = jnp.full((B,), 2 + j, jnp.int32)
        hidden, cache, valid = transformer_forward(
            t, params["transformer"],
            cond(emb_j, j)[:, None, :].astype(t.jnp_dtype),
            pos[:, None], cache, valid,
        )
        return (hidden[:, 0], cache, valid, key), (subcode_j, emb_j, logits_j)

    # steps 0..n-2 advance the transformer; the final step only samples
    (h_last, cache, valid, key), (subcodes, embs, logits) = lax.scan(
        step, (h_last, cache, valid, key), jnp.arange(n - 1, dtype=jnp.int32)
    )
    key, sub = split_keys(key, 2)
    logits_last = head_logits(h_last, n - 1)
    subcode_last = sample_fn(sub, logits_last)
    emb_last = jnp.take(pred_embed_tables[n - 1], subcode_last, axis=0)

    subcodes = jnp.moveaxis(subcodes, 0, 1)  # [B, n-1]
    subcodes = jnp.concatenate([subcodes, subcode_last[:, None]], axis=1)  # [B, n]
    sub_sum = jnp.sum(embs, axis=0) + emb_last  # [B, H]
    logits = jnp.concatenate(
        [jnp.moveaxis(logits, 0, 1), logits_last[:, None]], axis=1
    )  # [B, n, V]
    return subcodes, sub_sum.astype(last_hidden.dtype), logits


def predict_subcodes_dense(
    cfg: CodePredictorConfig,
    params: dict,
    pred_embed_tables: jax.Array,
    last_hidden: jax.Array,
    code0_embed: jax.Array,
    key: jax.Array,
    sample_fn: Callable[[jax.Array, jax.Array], jax.Array],
) -> Tuple[jax.Array, jax.Array]:
    """Cache-free variant: each step re-runs the whole <=17-token sequence.

    The MTP sequence is tiny, so a full forward costs the SAME weight bytes
    as an incremental step (HBM-bound) while deleting the per-step KV-cache
    carries/updates and validity bookkeeping — fewer ops inside the scan.
    Numerically equivalent to the cached path (same math, no masking
    subtleties: positions past the current length are excluded via `valid`).
    """
    from .layers import transformer_forward_nocache

    t = cfg.transformer
    B, H = last_hidden.shape
    n = cfg.num_steps
    S = n + 2  # [hidden, code0, n-1 sub embeds] + final slot unused as input

    head_logits = _head_fn(cfg, params)
    c0_add, cond = _step_cond(cfg, params)

    seq0 = jnp.zeros((B, S, H), t.jnp_dtype)
    seq0 = seq0.at[:, 0].set(last_hidden.astype(t.jnp_dtype))
    seq0 = seq0.at[:, 1].set((code0_embed + c0_add).astype(t.jnp_dtype))
    pos_ids = jnp.arange(S)

    def step(carry, j):
        seq, key = carry
        key, sub = split_keys(key, 2)
        valid = jnp.broadcast_to(pos_ids[None, :] < 2 + j, (B, S))
        hidden = transformer_forward_nocache(
            t, params["transformer"], seq, valid=valid
        )  # [B, S, H]
        h_j = jnp.take_along_axis(
            hidden, jnp.broadcast_to((1 + j)[None, None, None], (B, 1, H)), axis=1
        )[:, 0]
        logits_j = head_logits(h_j, j)
        subcode_j = sample_fn(sub, logits_j)  # [B]
        table = lax.dynamic_index_in_dim(pred_embed_tables, j, axis=0, keepdims=False)
        emb_j = jnp.take(table, subcode_j, axis=0)
        seq = lax.dynamic_update_slice(
            seq, cond(emb_j, j)[:, None, :].astype(t.jnp_dtype), (0, 2 + j, 0)
        )
        return (seq, key), (subcode_j, emb_j)

    (_, _), (subcodes, embs) = lax.scan(
        step, (seq0, key), jnp.arange(n, dtype=jnp.int32)
    )
    subcodes = jnp.moveaxis(subcodes, 0, 1)  # [B, n]
    sub_sum = jnp.sum(embs, axis=0)  # [B, H]
    return subcodes, sub_sum.astype(last_hidden.dtype)
