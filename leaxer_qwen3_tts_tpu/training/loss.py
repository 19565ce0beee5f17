"""Teacher-forced training loss for the Qwen3-TTS acoustic LM.

The reference is inference-only (no training loop anywhere, SURVEY §5); this
module adds fine-tuning capability: one jittable loss over
the same model code the decode loop uses.

Given text + ground-truth codec frames, reproduces the generation-time input
schedule exactly (prompt builder + text-drip + codec-sum inputs,
runtime/generate.py _frame_step) and computes:

  * talker loss — next-frame codebook-0 cross-entropy (+ CODEC_EOS at the
    position after the last real frame)
  * code-predictor loss — teacher-forced 15-step MTP cross-entropy with the
    per-step heads and per-step embedding tables

Both are masked means over real frames, so variable-length batches train
correctly with static shapes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import CODEC_EOS, TTSModelConfig
from ..models.embeddings import codec_embed
from ..models.layers import transformer_forward_nocache
from ..runtime.prompt import build_prompt


class LossMetrics(NamedTuple):
    loss: jax.Array
    talker_loss: jax.Array
    mtp_loss: jax.Array
    frames: jax.Array  # number of real target frames in the batch


def _cross_entropy(logits: jax.Array, targets: jax.Array) -> jax.Array:
    """Per-element CE in float32; logits [..., V], targets [...] int32."""
    logits = logits.astype(jnp.float32)
    logz = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, targets[..., None], axis=-1)[..., 0]
    return logz - gold


class TeacherForward(NamedTuple):
    """Everything the teacher-forced talker pass yields (shared by the main
    TTS loss and the speculative-draft loss)."""

    pred_hidden: jax.Array  # [B, F, H] — hidden that predicts frame f
    c0e: jax.Array  # [B, F, H] — codec_embed(code0)
    sub_e: jax.Array  # [B, F, S, H] — per-step sub-code embeddings
    sub_sum: jax.Array  # [B, F, H]
    frame_valid: jax.Array  # [B, F] bool


def teacher_forward(
    cfg: TTSModelConfig,
    params: dict,
    text_ids: jax.Array,
    text_len: jax.Array,
    codes: jax.Array,  # [B, F, 16]
    num_frames: jax.Array,
    lang_id: Optional[int] = None,
) -> TeacherForward:
    """Teacher-forced talker pass with the generation-time input schedule."""
    t = cfg.talker.transformer
    emb = params["embeddings"]
    B, F, G = codes.shape

    bundle = build_prompt(emb, text_ids, text_len, lang_id)
    P = bundle.prompt_embeds.shape[1]

    frame_ids = jnp.arange(F, dtype=jnp.int32)
    frame_valid = frame_ids[None, :] < num_frames[:, None]  # [B, F]

    # --- generation-time frame inputs (teacher forced) ---------------------
    code0 = codes[..., 0]  # [B, F]
    c0e = codec_embed(emb, code0)  # [B, F, H]
    subs = codes[..., 1:]  # [B, F, S]
    # per-step sub embeddings: tables [S, V, H] indexed per step
    sub_e = jax.vmap(
        lambda table, ids: jnp.take(table, ids, axis=0), in_axes=(0, 2), out_axes=2
    )(emb["pred_embed"], subs)  # [B, F, S, H]
    sub_sum = jnp.sum(sub_e, axis=2)  # [B, F, H]

    # text drip: frame f gets trailing[f] while f < trailing_len, else TTS_PAD
    T = bundle.trailing.shape[1]
    drip_idx = jnp.minimum(frame_ids, T - 1)
    drip = bundle.trailing[:, drip_idx]  # [B, F, H]
    use_text = frame_ids[None, :] < bundle.trailing_len[:, None]
    drip = jnp.where(
        use_text[..., None], drip, bundle.tts_pad_embed[None, None, :].astype(drip.dtype)
    )
    frame_in = (c0e + sub_sum + drip).astype(t.jnp_dtype)  # [B, F, H]

    # --- talker forward (full teacher-forced sequence, no cache) -----------
    seq = jnp.concatenate([bundle.prompt_embeds.astype(t.jnp_dtype), frame_in], axis=1)
    L = P + F
    positions = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32), (B, L))
    seq_valid = jnp.concatenate(
        [jnp.ones((B, P), bool), frame_valid], axis=1
    )  # pad frames don't attend / get attended
    hidden = transformer_forward_nocache(
        t, params["talker"]["transformer"], seq, positions, valid=seq_valid
    )  # [B, L, H]

    # positions P-1+f predict frame f (f in [0, F)); position P-1+n predicts EOS
    pred_hidden = hidden[:, P - 1 : P - 1 + F]  # [B, F, H]
    return TeacherForward(
        pred_hidden=pred_hidden, c0e=c0e, sub_e=sub_e, sub_sum=sub_sum,
        frame_valid=frame_valid,
    )


def tts_loss(
    cfg: TTSModelConfig,
    params: dict,
    text_ids: jax.Array,  # [B, T] int32 (right-padded)
    text_len: jax.Array,  # [B] int32
    codes: jax.Array,  # [B, F, 16] int32 ground-truth codec frames
    num_frames: jax.Array,  # [B] int32 real frame counts (<= F)
    lang_id: Optional[int] = None,
    mtp_weight: float = 1.0,
) -> LossMetrics:
    B, F, G = codes.shape
    S = cfg.code_predictor.num_steps  # 15 sub-codebooks
    H = cfg.talker.transformer.hidden_size
    code0 = codes[..., 0]
    subs = codes[..., 1:]
    frame_ids = jnp.arange(F, dtype=jnp.int32)

    tf = teacher_forward(cfg, params, text_ids, text_len, codes, num_frames, lang_id)
    pred_hidden, c0e, sub_e = tf.pred_hidden, tf.c0e, tf.sub_e
    frame_valid = tf.frame_valid

    logits0 = jnp.dot(
        pred_hidden, params["talker"]["lm_head"], preferred_element_type=jnp.float32
    )  # [B, F, Vc]
    is_eos_pos = frame_ids[None, :] == num_frames[:, None]
    targets0 = jnp.where(is_eos_pos, CODEC_EOS, code0)
    target_mask = (frame_valid | is_eos_pos).astype(jnp.float32)
    ce0 = _cross_entropy(logits0, targets0) * target_mask
    talker_loss = jnp.sum(ce0) / jnp.maximum(jnp.sum(target_mask), 1.0)

    # --- code-predictor MTP loss (teacher forced, batched over frames) -----
    pt = cfg.code_predictor.transformer
    # sequence per frame: [talker_hidden, codec_embed(code0), sub_e[0..S-2]]
    mtp_seq = jnp.concatenate(
        [
            pred_hidden[:, :, None, :],
            c0e[:, :, None, :],
            sub_e[:, :, : S - 1, :],
        ],
        axis=2,
    ).astype(pt.jnp_dtype)  # [B, F, S+1, H]
    mtp_seq = mtp_seq.reshape(B * F, S + 1, H)
    mtp_hidden = transformer_forward_nocache(
        pt, params["code_predictor"]["transformer"], mtp_seq
    )  # [B*F, S+1, H]
    # output at index j+1 with head j predicts sub-code j (codebook j+1)
    step_hidden = mtp_hidden[:, 1:, :].reshape(B, F, S, H)
    logits_sub = jnp.einsum(
        "bfsh,shv->bfsv",
        step_hidden.astype(jnp.float32),
        params["code_predictor"]["heads"].astype(jnp.float32),
    )  # [B, F, S, 2048]
    ce_sub = _cross_entropy(logits_sub, subs)  # [B, F, S]
    sub_mask = jnp.broadcast_to(frame_valid[..., None], ce_sub.shape).astype(jnp.float32)
    mtp = jnp.sum(ce_sub * sub_mask) / jnp.maximum(jnp.sum(sub_mask), 1.0)

    loss = talker_loss + mtp_weight * mtp
    return LossMetrics(
        loss=loss,
        talker_loss=talker_loss,
        mtp_loss=mtp,
        frames=jnp.sum(frame_valid),
    )
