"""The jitted generation loop: prefill once, then chunked on-device decode.

Where the reference pays ~33 ONNX session invocations and a full host<->device
KV round-trip per 12 Hz frame (SURVEY §3.1; tts_onnx.cpp:801-846, :684-729),
here one frame is ONE fused jitted step inside a ``lax.scan``:

    sample code0 -> 15-step MTP scan -> embed sum (+ text drip) -> talker step

The decode loop runs ``chunk_len`` frames per dispatch so the host only syncs
once per chunk — the sync point doubles as the streaming-vocoder hand-off, which
is how time-to-first-audio beats the reference's vocode-once-at-the-end design
(tts_onnx.cpp:430).

EOS is latched per sequence (batched multi-stream serving: streams finish
independently; finished streams keep stepping but their frames are marked
invalid, matching the reference's emit-nothing-after-EOS break at :812).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import CODEC_EOS, TTSModelConfig
from ..models.code_predictor import predict_subcodes
from ..models.embeddings import codec_embed
from ..models.layers import KVCache
from ..models.talker import talker_decode_step, talker_init_cache, talker_prefill
from .prompt import PromptBundle, build_prompt
from .sampling import (
    SamplingParams,
    make_codec_suppress_mask,
    sample_token,
    split_keys,
)


class GenerateState(NamedTuple):
    cache: KVCache
    valid_mask: jax.Array  # [B, T] bool
    last_logits: jax.Array  # [B, V] f32
    last_hidden: jax.Array  # [B, H]
    pos: jax.Array  # [B] int32 — RoPE position of the next token
    step: jax.Array  # [B] int32 — frames generated so far, PER STREAM
    # (per-stream so continuous serving can admit a new request into a slot
    # mid-flight: its text drip restarts at 0 while batch-mates keep going)
    done: jax.Array  # [B] bool — EOS latched
    key: jax.Array  # PRNG key: [2] (one chain) or [B, 2] (per-stream chains;
    # the pool carries per-slot keys so a request's samples are
    # occupancy-invariant — runtime/sampling.split_keys)


def init_state_from_prefill(
    cfg: TTSModelConfig,
    params: dict,
    bundle: PromptBundle,
    cache: KVCache,
    key: jax.Array,
) -> GenerateState:
    last_logits, last_hidden, cache, valid_mask = talker_prefill(
        cfg.talker, params["talker"], bundle.prompt_embeds, bundle.prompt_len, cache
    )
    B = bundle.prompt_embeds.shape[0]
    return GenerateState(
        cache=cache,
        valid_mask=valid_mask,
        last_logits=last_logits,
        last_hidden=last_hidden,
        pos=bundle.prompt_len,
        step=jnp.zeros((B,), jnp.int32),
        done=jnp.zeros((B,), bool),
        key=key,
    )


def _compute_drip(state: GenerateState, trailing, trailing_len,
                  tts_pad_embed) -> jax.Array:
    """This frame's text-drip embedding [B, H] (reference tts_onnx.cpp:
    823-842).  A one-hot contraction rather than a per-row gather; the
    mask-sum is bit-exact (x * 1.0 + 0.0 == x)."""
    T = trailing.shape[1]
    drip_idx = jnp.minimum(state.step, T - 1)  # [B] per-stream drip cursor
    oh = (
        drip_idx[:, None] == jnp.arange(T, dtype=jnp.int32)[None, :]
    ).astype(trailing.dtype)  # [B, T]
    drip = jnp.einsum(
        "bt,bth->bh", oh, trailing, preferred_element_type=jnp.float32
    ).astype(trailing.dtype)  # [B, H]
    use_text = state.step < trailing_len  # [B]
    return jnp.where(
        use_text[:, None], drip, tts_pad_embed[None, :].astype(drip.dtype)
    )


def _frame_step(
    cfg: TTSModelConfig,
    params: dict,
    suppress: jax.Array,
    trailing: jax.Array,
    trailing_len: jax.Array,
    tts_pad_embed: jax.Array,
    sp: SamplingParams,
    state: GenerateState,
    uniform_fill: bool = True,
) -> Tuple[GenerateState, Tuple[jax.Array, jax.Array]]:
    """One 12 Hz frame.  Returns (state', (frame_codes [B,16], frame_valid [B]))."""
    emb = params["embeddings"]
    key, k_code0, k_pred = split_keys(state.key, 3)

    # --- codebook 0: suppress control tokens except EOS, sample ---
    logits = state.last_logits + suppress[None, :]
    logits = logits.at[:, CODEC_EOS].add(jnp.where(sp.forbid_eos, -1e30, 0.0))
    code0 = sample_token(k_code0, logits, sp)  # [B]
    is_eos = code0 == CODEC_EOS
    frame_valid = (~state.done) & (~is_eos)
    done = state.done | is_eos

    # --- codebooks 1..15: MTP scan ---
    code0_embed = codec_embed(emb, code0)  # [B, H]
    sample_fn = lambda k, lg: sample_token(k, lg, sp)
    subcodes, sub_sum = predict_subcodes(
        cfg.code_predictor,
        params["code_predictor"],
        emb["pred_embed"],
        state.last_hidden,
        code0_embed,
        k_pred,
        sample_fn,
    )
    frame = jnp.concatenate([code0[:, None], subcodes], axis=1)  # [B, 16]
    frame = jnp.where(frame_valid[:, None], frame, 0)

    # --- next talker input: codec sum + text drip (reference :823-842) ---
    drip = _compute_drip(state, trailing, trailing_len, tts_pad_embed)
    next_embed = (code0_embed + sub_sum + drip).astype(code0_embed.dtype)

    # --- talker decode step ---
    logits2, hidden2, cache, valid_mask = talker_decode_step(
        cfg.talker, params["talker"], next_embed, state.pos, state.cache,
        state.valid_mask, uniform_fill=uniform_fill,
    )

    new_state = GenerateState(
        cache=cache,
        valid_mask=valid_mask,
        last_logits=logits2,
        last_hidden=hidden2,
        pos=state.pos + 1,
        step=state.step + 1,
        done=done,
        key=key,
    )
    return new_state, (frame, frame_valid)


def decode_frames(
    cfg: TTSModelConfig,
    params: dict,
    state: GenerateState,
    trailing: jax.Array,
    trailing_len: jax.Array,
    tts_pad_embed: jax.Array,
    sp: SamplingParams,
    num_frames: int,
    uniform_fill: bool = True,
) -> Tuple[GenerateState, jax.Array, jax.Array]:
    """Run ``num_frames`` frames (static) via lax.scan.

    Returns (state, frames [B, num_frames, 16] int32, valid [B, num_frames] bool).
    """
    suppress = make_codec_suppress_mask(cfg.talker.codec_vocab_size)
    step = functools.partial(
        _frame_step, cfg, params, suppress, trailing, trailing_len,
        tts_pad_embed, sp, uniform_fill=uniform_fill,
    )
    state, (frames, valid) = lax.scan(lambda s, _: step(s), state, None, length=num_frames)
    frames = jnp.moveaxis(frames, 0, 1)  # [B, F, 16]
    valid = jnp.moveaxis(valid, 0, 1)  # [B, F]
    return state, frames, valid


class GenerateFns(NamedTuple):
    """Jitted entry points bound to one (model config, batch, cache bucket)."""

    prefill: callable  # (params, text_ids, text_len, key, speaker_embed?) -> (state, bundle)
    decode: callable  # (params, state, bundle, sp) -> (state, frames, valid)


def make_generate_fns(
    cfg: TTSModelConfig,
    batch: int,
    max_len: int,
    chunk_len: int = 32,
    lang_id: Optional[int] = None,
    has_speaker: bool = False,
    has_instruct: bool = False,
    donate: bool = True,
    uniform_fill: bool = True,
) -> GenerateFns:
    """Build jitted prefill / decode-chunk functions.

    ``max_len`` is the KV-cache bucket (prompt + frames); ``chunk_len`` the frames
    per host dispatch.  The decode chunk donates the state so the KV cache is
    updated in place in device memory.
    """

    def prefill_impl(params, text_ids, text_len, key, speaker_embed=None,
                     instruct_ids=None, instruct_len=None):
        bundle = build_prompt(
            params["embeddings"],
            text_ids,
            text_len,
            lang_id,
            speaker_embed if has_speaker else None,
            instruct_ids if has_instruct else None,
            instruct_len if has_instruct else None,
        )
        cache = talker_init_cache(cfg.talker, batch, max_len)
        state = init_state_from_prefill(cfg, params, bundle, cache, key)
        return state, bundle

    def decode_impl(params, state, trailing, trailing_len, tts_pad_embed, sp):
        return decode_frames(
            cfg, params, state, trailing, trailing_len, tts_pad_embed, sp,
            chunk_len, uniform_fill=uniform_fill,
        )

    prefill = jax.jit(prefill_impl)
    decode = jax.jit(decode_impl, donate_argnums=(1,) if donate else ())
    return GenerateFns(prefill=prefill, decode=decode)
