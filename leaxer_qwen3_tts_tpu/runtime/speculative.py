"""Frame-level speculative decoding: break the per-frame weight-read chain.

Sequential decode (runtime/generate.py) reads the full talker plus the MTP
trunk 15x per 12 Hz frame, so at small batch a frame costs about one read of
the weights.  This module verifies K drafted frames
with ONE S=K talker pass and ONE MTP chain batched over the K frames, so the
weight bytes amortize over every accepted frame (arXiv 2410.21951 /
2410.13839 apply the idea to AR-codec TTS; the reference
(src/tts_onnx.cpp:801-846) has no analog — its inner loop is
strictly one-frame-at-a-time).

Batched (B > 1) serving multiplies the effect: one verify pass covers
B x K frame slots, with PER-STREAM acceptance, rewinds, and EOS latching
(streams commit different counts each iteration; cache fill levels diverge
and the per-sequence-length machinery in models/layers.py handles it).

EXACTNESS.  Unlike classic speculative sampling, the committed codes are
ALWAYS produced by the exact model: the draft only chooses which inputs get
prefetched into the verify pass.  A talker input embed is a pure function of
the frame's 16 codes (codec_embed(code0) + sum_j table_j[subcode_j] — see
models/code_predictor.py), so when the draft's codes match the exact codes,
the verify pass's hidden states ARE the sequential hidden states, and the
next candidate is valid.  Greedy (temperature=0) output is therefore
bit-identical to the sequential loop at any acceptance rate.  With
temperature > 0 the committed trajectory samples the SAME per-frame
conditional distributions; the PRNG stream matches the sequential loop for
code0 at B=1 (per-frame chain keys), while the MTP sub-code stream (and, at
B>1, the per-stream frame-index/key alignment) differs — distribution-equal,
not bit-equal.

One iteration (K inputs per stream):

  inputs   = [embed(pending)] + [embed(draft_1) ... embed(draft_{K-1})]
  verify   = talker forward S=K              (weights read ONCE)
  cand[i]  = sample(logits[i]), MTP(hidden[i], cand0[i])   for i = 0..K-1
             (MTP batched over all B*K candidates: trunk read ONCE)
  n_b      = longest prefix with cand[i] == draft_{i+1}   (per stream)
  commit   = cand[0..n_b]                    (n_b matched drafts + 1 bonus)

Worst case commits 1 frame/stream for ~1 sequential frame's bytes; best case
commits K.  The shipped draft is "repeat" (draft_j = pending frame): free,
and accepts on sustained/silent stretches.  `draft_fn` is pluggable — see
models/draft.py for the trained EAGLE-style head.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import CODEC_EOS, TTSModelConfig
from ..models.code_predictor import predict_subcodes
from ..models.embeddings import codec_embed
from ..models.layers import KVCache, transformer_forward
from ..ops.quant import dense
from .prompt import PromptBundle, build_prompt
from .sampling import (
    SamplingParams,
    make_codec_suppress_mask,
    sample_token,
    split_keys,
)


class SpecState(NamedTuple):
    """Loop state for speculative decode (B streams).

    The invariant between iterations: `pending[b]` is stream b's last
    committed frame, whose talker input embed (pending_nodrip + its text
    drip) has NOT been consumed yet; the KV cache holds exactly the prompt
    plus the inputs of all earlier committed frames (cache.length[b] is the
    stream's next write slot — fills diverge as streams accept differently).
    """

    cache: KVCache
    valid_mask: jax.Array  # [B, T] bool
    pending: jax.Array  # [B, 16] int32 — last committed frame's codes
    pending_nodrip: jax.Array  # [B, H] — its code0_embed + sub_sum (exact)
    pending_hidden: jax.Array  # [B, H] — talker hidden that produced it
    # (the EAGLE-style draft conditions on (hidden, embed); repeat_draft
    # ignores it)
    rope_pos: jax.Array  # [B] int32 — RoPE position of the pending input
    step: jax.Array  # [B] int32 — frames committed so far (incl. pending)
    done: jax.Array  # [B] bool — EOS latched
    key: jax.Array  # [2] (one chain) or [B, 2] (per-stream chains — pool
    # slots advance independently, so samples are occupancy-invariant)


def init_spec_state(
    cfg: TTSModelConfig,
    params: dict,
    bundle: PromptBundle,
    cache: KVCache,
    key: jax.Array,
    sp: SamplingParams,
) -> Tuple[SpecState, jax.Array, jax.Array]:
    """Prefill + the first frame (code0 from prefill logits + its MTP run,
    exactly the non-talker half of generate._frame_step).

    Returns (state, frame0 [B, 16], valid0 [B]).
    """
    from ..models.talker import talker_prefill

    emb = params["embeddings"]
    suppress = make_codec_suppress_mask(cfg.talker.codec_vocab_size)
    last_logits, last_hidden, cache, valid_mask = talker_prefill(
        cfg.talker, params["talker"], bundle.prompt_embeds, bundle.prompt_len,
        cache,
    )
    B = bundle.prompt_embeds.shape[0]
    key, k_code0, k_pred = split_keys(key, 3)
    logits = last_logits + suppress[None, :]
    logits = logits.at[:, CODEC_EOS].add(jnp.where(sp.forbid_eos, -1e30, 0.0))
    code0 = sample_token(k_code0, logits, sp)  # [B]
    is_eos = code0 == CODEC_EOS

    code0_embed = codec_embed(emb, code0)
    sample_fn = lambda k, lg: sample_token(k, lg, sp)
    subcodes, sub_sum = predict_subcodes(
        cfg.code_predictor, params["code_predictor"], emb["pred_embed"],
        last_hidden, code0_embed, k_pred, sample_fn,
    )
    frame = jnp.concatenate([code0[:, None], subcodes], axis=1)  # [B, 16]
    valid = ~is_eos
    state = SpecState(
        cache=cache,
        valid_mask=valid_mask,
        pending=frame,
        pending_nodrip=code0_embed + sub_sum,
        pending_hidden=last_hidden,
        rope_pos=bundle.prompt_len,
        step=jnp.ones((B,), jnp.int32),
        done=is_eos,
        key=key,
    )
    return state, jnp.where(valid[:, None], frame, 0), valid


def repeat_draft(
    state: SpecState, k: int
) -> Tuple[jax.Array, Optional[jax.Array]]:
    """The zero-cost draft: every drafted frame repeats the pending frame.

    Returns (codes [B, k-1, 16], nodrip [B, k-1, H]): reusing the pending
    frame's exact embed sum keeps accepted verify inputs BIT-identical to
    the sequential loop's (a recompute could differ in reduction order from
    the MTP scan's sum and flip knife-edge greedy ties)."""
    B, H = state.pending_nodrip.shape
    return (
        jnp.broadcast_to(state.pending[:, None, :], (B, k - 1, 16)),
        jnp.broadcast_to(state.pending_nodrip[:, None, :], (B, k - 1, H)),
    )


def make_replay_draft(traj) -> Callable:
    """Structural oracle draft: replay a recorded trajectory.

    ``traj`` [F, 16] int32 — frame f of a greedy decode of the same prompt
    (e.g. recorded from the sequential loop).  The spec invariant puts
    ``state.pending == traj[state.step - 1]``, and candidate slot j verifies
    frame ``state.step + j - 1``, so drafting ``traj[state.step + j]`` for
    slot j+1 makes every draft match its greedy candidate: acceptance is 1.0
    BY CONSTRUCTION for any weights (greedy committed codes are bit-identical
    to the sequential loop — see the module docstring).  This is the
    benchmark/test oracle for the full-acceptance ceiling; a
    weight-behavior-dependent "hope greedy repeats" probe degenerates to the
    floor whenever the weight fill lacks a repetition attractor (the round-3
    BENCH regression).  Works at any B: per-stream steps index independently.
    """
    traj = jnp.asarray(traj, jnp.int32)
    F = traj.shape[0]

    def draft(state: SpecState, k: int):
        def one(s):
            start = jnp.clip(s, 0, F - (k - 1))
            return lax.dynamic_slice(traj, (start, 0), (k - 1, 16))

        return jax.vmap(one)(state.step), None

    return draft


def _spec_iteration(
    cfg: TTSModelConfig,
    params: dict,
    suppress: jax.Array,
    trailing: jax.Array,
    trailing_len: jax.Array,
    tts_pad_embed: jax.Array,
    sp: SamplingParams,
    k: int,
    draft_fn: Callable[[SpecState, int], jax.Array],
    state: SpecState,
    uniform_fill: bool,
    force_accept: bool = False,
) -> Tuple[SpecState, Tuple[jax.Array, jax.Array]]:
    """One verify iteration.  Returns (state', (frames [B, k, 16],
    valid [B, k])) where uncommitted candidate slots are zeroed/invalid.

    ``force_accept`` is the BENCHMARK-ONLY structural ceiling probe: the
    draft-match comparison is replaced by all-true, so every iteration
    commits k frames — the full-acceptance regime by construction, for ANY
    weights.  All compute (verify pass, MTP chain, cache append, drip,
    sampling) is identical to a genuine full-acceptance iteration; only the
    boolean match is overridden, so the measured ms/frame is the true
    ceiling cost.  (A weight-behavior probe — "hope greedy repeats", or
    even a replayed greedy trajectory — silently degenerates whenever the
    weight fill yields tied logits that break differently between the S=1
    and S=K programs: the round-3 BENCH regression.)  Never used in
    production paths."""
    emb = params["embeddings"]
    t = cfg.talker.transformer
    B = state.pending.shape[0]

    # --- the per-frame PRNG chain, pre-split k frames ahead ---------------
    # NOTE: the 3-way split per slot mirrors the sequential loop's per-frame
    # (key, k_code0, k_pred) chain so the B=1 code0 draws are bit-identical;
    # keys_pred[1:] are intentionally unused — the batched MTP shares
    # keys_pred[0] (sampled sub-code streams are distribution-equal, see the
    # module docstring) but the splits must still happen to keep the chain
    # values aligned with generate._frame_step.
    keys_code0, keys_pred, keys_after = [], [], []
    key = state.key
    per_row = key.ndim == 2  # per-slot chains (pool determinism)
    for _ in range(k):
        key, kc, kp = split_keys(key, 3)
        keys_code0.append(kc)
        keys_pred.append(kp)
        keys_after.append(key)
    keys_after = jnp.stack(keys_after)  # [k, 2] or [k, B, 2]

    # --- build the K talker inputs per stream -----------------------------
    drafts, d_nodrip = draft_fn(state, k)  # [B, k-1, 16], [B, k-1, H]|None
    if d_nodrip is None:
        # model-based drafts: reconstruct the embed sum from the codes with
        # the same gather + reduction GROUPING predict_subcodes uses for the
        # active impl, so accepted drafts' verify inputs match the
        # sequential loop's bit-for-bit (the cached impl sums the
        # first 14 step-embeds then add the last; the dense impl sums all
        # 15 in one reduce — the groupings can differ in the last ulp and
        # flip knife-edge greedy ties)
        d_code0_embed = codec_embed(emb, drafts[..., 0])  # [B, k-1, H]
        tables = emb["pred_embed"]  # [15, Vs, H]
        d_embs = jax.vmap(
            lambda tab, c: jnp.take(tab, c, axis=0), in_axes=(0, 2), out_axes=2
        )(tables, drafts[..., 1:])  # [B, k-1, 15, H]
        if cfg.code_predictor.impl == "dense":
            d_sub_sum = jnp.sum(d_embs, axis=-2)
        else:
            d_sub_sum = (
                jnp.sum(d_embs[..., :-1, :], axis=-2) + d_embs[..., -1, :]
            )
        d_nodrip = d_code0_embed + d_sub_sum  # [B, k-1, H]
    nodrip = jnp.concatenate(
        [state.pending_nodrip[:, None, :], d_nodrip], axis=1
    )  # [B, k, H]

    # text drip at each stream's own frame indices (mirrors generate.py's
    # one-hot contraction).
    Ttr = trailing.shape[1]
    drip_idx = (state.step - 1)[:, None] + jnp.arange(k, dtype=jnp.int32)  # [B, k]
    oh_drip = (
        jnp.minimum(drip_idx, Ttr - 1)[..., None]
        == jnp.arange(Ttr, dtype=jnp.int32)[None, None, :]
    ).astype(trailing.dtype)  # [B, k, Ttr]
    drip = jnp.einsum(
        "bkt,bth->bkh", oh_drip, trailing, preferred_element_type=jnp.float32
    ).astype(trailing.dtype)  # [B, k, H]
    use_text = drip_idx < trailing_len[:, None]
    drip = jnp.where(
        use_text[..., None], drip, tts_pad_embed[None, None, :].astype(drip.dtype)
    )
    inputs = (nodrip + drip).astype(t.jnp_dtype)  # [B, k, H]

    # --- ONE talker pass over all B*K inputs (weights read once) ----------
    positions = state.rope_pos[:, None] + jnp.arange(k, dtype=jnp.int32)[None]
    hidden, cache, valid_mask = transformer_forward(
        t, params["talker"]["transformer"], inputs, positions,
        state.cache, state.valid_mask, uniform_fill=uniform_fill,
    )  # hidden [B, k, H]
    logits_all = dense(hidden, params["talker"]["lm_head"])  # [B, k, V]

    # --- exact candidate code0 per slot (chain key j shared across streams,
    # exactly like the sequential batched loop's per-frame keys) -----------
    li_all = logits_all + suppress[None, None, :]  # [B, k, V]
    eos_pen = jnp.where(sp.forbid_eos, -1e30, 0.0)  # scalar or [B] (pool)
    if eos_pen.ndim == 1:
        eos_pen = eos_pen[:, None]  # broadcast over the k candidate slots
    li_all = li_all.at[..., CODEC_EOS].add(eos_pen)
    cand0 = jax.vmap(
        lambda kk, lg: sample_token(kk, lg, sp), in_axes=(0, 1), out_axes=1
    )(jnp.stack(keys_code0), li_all)  # [B, k]

    # --- ONE MTP chain batched over all B*K candidates (trunk read once) --
    c0e = codec_embed(emb, cand0)  # [B, k, H]
    # per-slot sampling knobs (pool: [B] vectors) tile to the flattened
    # [B*k] candidate rows; scalars pass through
    sp_flat = jax.tree.map(
        lambda v: jnp.repeat(v, k, axis=0) if getattr(v, "ndim", 0) == 1 else v,
        sp,
    )
    sample_fn = lambda kk, lg: sample_token(kk, lg, sp_flat)
    H = c0e.shape[-1]
    # per-row chains: flattened candidate row (b, j) samples with slot j's
    # split of STREAM b's chain (keys_pred[j][b]) — matching the flattened
    # hidden/c0e row order, so a stream's sub-code draws never depend on
    # batch-mates.  Scalar chain keeps the shared keys_pred[0] (module
    # docstring: distribution-equal).
    k_pred_mtp = (
        jnp.stack(keys_pred, axis=1).reshape(B * k, 2)
        if per_row
        else keys_pred[0]
    )
    subcodes, sub_sums = predict_subcodes(
        cfg.code_predictor, params["code_predictor"], emb["pred_embed"],
        hidden.reshape(B * k, H), c0e.reshape(B * k, H), k_pred_mtp,
        sample_fn,
    )
    subcodes = subcodes.reshape(B, k, 15)
    sub_sums = sub_sums.reshape(B, k, H)
    cand = jnp.concatenate([cand0[..., None], subcodes], axis=-1)  # [B, k, 16]

    # --- acceptance per stream: longest draft-matching prefix -------------
    match = jnp.all(cand[:, : k - 1] == drafts, axis=-1)  # [B, k-1]
    if force_accept:  # structural ceiling probe (see docstring) — bench only
        match = jnp.ones_like(match)
    n_match = jnp.sum(jnp.cumprod(match.astype(jnp.int32), axis=1), axis=1)
    m = n_match + 1  # [B] committed candidates: cand[b, 0..m_b-1]

    # --- EOS / validity (mirrors generate._frame_step latching) -----------
    is_eos = cand0 == CODEC_EOS  # [B, k]
    idx = jnp.arange(k, dtype=jnp.int32)[None, :]
    committed = idx < m[:, None]
    eos_before = jnp.cumsum(is_eos.astype(jnp.int32), axis=1) - is_eos.astype(
        jnp.int32
    )
    valid = committed & ~state.done[:, None] & (eos_before == 0) & ~is_eos
    done = state.done | jnp.any(is_eos & committed, axis=1)
    frames_out = jnp.where(valid[..., None], cand, 0)  # [B, k, 16]

    # --- roll each stream to its bonus frame ------------------------------
    # FREEZE streams that entered the iteration done: a finished stream must
    # not keep consuming KV slots (at up to k/iteration its repeat-draft
    # self-accepts the repetitive post-EOS output, races ahead of live
    # batch-mates, and can exhaust the shared bucket budget).  A stream that
    # EOSes THIS iteration still advances once — its committed inputs were
    # genuinely consumed — then freezes.
    m_adv = jnp.where(state.done, 0, m)  # [B]
    # one-hot masked sums select one of k rows; bit-exact (x + 0.0 == x)
    oh = (
        jnp.arange(k, dtype=jnp.int32)[None, :] == (m - 1)[:, None]
    )  # [B, k]
    frozen = state.done[:, None]
    new_pending = jnp.where(
        frozen, state.pending,
        jnp.sum(jnp.where(oh[..., None], cand, 0), axis=1),
    )  # [B, 16]
    ohf = oh[..., None].astype(c0e.dtype)
    new_nodrip = jnp.where(
        frozen, state.pending_nodrip,
        jnp.sum((c0e + sub_sums) * ohf, axis=1).astype(
            state.pending_nodrip.dtype
        ),
    )  # [B, H]
    new_hidden = jnp.where(
        frozen, state.pending_hidden,
        jnp.sum(hidden * ohf.astype(hidden.dtype), axis=1).astype(
            state.pending_hidden.dtype
        ),
    )  # [B, H]
    # rewind each stream's fill past its committed inputs only: slots beyond
    # length' hold mismatched-draft K/V and are masked out until overwritten
    new_len = state.cache.length + m_adv  # [B]
    cache = cache._replace(length=new_len)
    slot_ids = jnp.arange(cache.max_len, dtype=jnp.int32)
    valid_mask = valid_mask & (slot_ids[None, :] < new_len[:, None])

    new_state = SpecState(
        cache=cache,
        valid_mask=valid_mask,
        pending=new_pending,
        pending_nodrip=new_nodrip,
        pending_hidden=new_hidden,
        rope_pos=state.rope_pos + m_adv,
        step=state.step + m_adv,
        done=done,
        # the chain advances one split per candidate slot; commit depth sets
        # the resume point (matches the B=1 sequential chain exactly).
        # one-hot select (uint32 mask-sum), not a dynamic gather.
        # Per-row chains resume PER STREAM at that stream's own commit depth.
        key=(
            jnp.sum(
                keys_after
                * (
                    jnp.arange(k, dtype=jnp.int32)[:, None] == (m - 1)[None, :]
                )[..., None].astype(keys_after.dtype),
                axis=0,
            )
            if per_row
            else jnp.sum(
                keys_after
                * (
                    jnp.arange(k, dtype=jnp.int32) == jnp.max(m) - 1
                )[:, None].astype(keys_after.dtype),
                axis=0,
            )
        ),
    )
    return new_state, (frames_out, valid)


def decode_frames_spec(
    cfg: TTSModelConfig,
    params: dict,
    state: SpecState,
    trailing: jax.Array,
    trailing_len: jax.Array,
    tts_pad_embed: jax.Array,
    sp: SamplingParams,
    k: int,
    num_iters: int,
    draft_fn: Callable[[SpecState, int], jax.Array] = repeat_draft,
    uniform_fill: Optional[bool] = None,
    force_accept: bool = False,
) -> Tuple[SpecState, jax.Array, jax.Array]:
    """Run `num_iters` verify iterations via lax.scan.

    Returns (state', frames [B, num_iters * k, 16], valid [B, num_iters*k]):
    committed frames appear in per-stream order with valid=True; uncommitted
    candidate slots and post-EOS frames are zeroed with valid=False —
    callers compact per stream on the valid mask (commit counts are
    data-dependent and diverge across streams).
    """
    B = state.pending.shape[0]
    if uniform_fill is None:
        # B=1 keeps the cheap contiguous cache write; B>1 streams diverge
        uniform_fill = B == 1
    suppress = make_codec_suppress_mask(cfg.talker.codec_vocab_size)
    step = functools.partial(
        _spec_iteration, cfg, params, suppress, trailing, trailing_len,
        tts_pad_embed, sp, k, draft_fn,
    )
    state, (frames, valid) = lax.scan(
        lambda s, _: (
            step(s, uniform_fill=uniform_fill, force_accept=force_accept)
        ),
        state, None, length=num_iters,
    )
    # [iters, B, k, ...] -> [B, iters*k, ...] in commit order
    frames = jnp.moveaxis(frames, 0, 1).reshape(B, num_iters * k, 16)
    valid = jnp.moveaxis(valid, 0, 1).reshape(B, num_iters * k)
    return state, frames, valid


def spec_to_seq(
    cfg: TTSModelConfig,
    params: dict,
    state: SpecState,
    trailing: jax.Array,
    trailing_len: jax.Array,
    tts_pad_embed: jax.Array,
    uniform_fill: bool = True,
):
    """Convert a SpecState into a sequential GenerateState (adaptive-spec
    fallback: when trailing acceptance is too low, speculative decode costs
    more than it commits — consume the pending frame's talker input with ONE
    decode step, after which the plain loop continues exactly as if it had
    produced every committed frame itself).

    The spec invariant says ``pending``'s input embed (pending_nodrip + its
    text drip at index step-1) has not been consumed; after this step the
    returned state's last_logits sample the next frame, matching
    generate._frame_step's contract (greedy continuation is identical to a
    from-scratch sequential decode of the same committed prefix)."""
    from ..models.talker import talker_decode_step
    from .generate import GenerateState

    t = cfg.talker.transformer
    B = state.pending_nodrip.shape[0]
    Ttr = trailing.shape[1]
    drip_idx = jnp.minimum(state.step - 1, Ttr - 1)  # [B]
    oh = (
        drip_idx[:, None] == jnp.arange(Ttr, dtype=jnp.int32)[None, :]
    ).astype(trailing.dtype)
    drip = jnp.einsum(
        "bt,bth->bh", oh, trailing, preferred_element_type=jnp.float32
    ).astype(trailing.dtype)
    use_text = (state.step - 1) < trailing_len
    drip = jnp.where(
        use_text[:, None], drip, tts_pad_embed[None, :].astype(drip.dtype)
    )
    embed = (state.pending_nodrip + drip).astype(t.jnp_dtype)
    logits, hidden, cache, valid_mask = talker_decode_step(
        cfg.talker, params["talker"], embed, state.rope_pos, state.cache,
        state.valid_mask, uniform_fill=uniform_fill,
    )
    return GenerateState(
        cache=cache,
        valid_mask=valid_mask,
        last_logits=logits,
        last_hidden=hidden,
        pos=state.rope_pos + 1,
        step=state.step,
        done=state.done,
        key=state.key,
    )


class SpecGenerateFns(NamedTuple):
    prefill: callable  # (params, ids, lens, key, ...) -> (state, bundle, frame0, valid0)
    decode: callable  # (params, state, trailing, trailing_len, pad, sp) -> (state, frames, valid)


def make_spec_generate_fns(
    cfg: TTSModelConfig,
    max_len: int,
    k: int = 4,
    num_iters: int = 8,
    batch: int = 1,
    lang_id: Optional[int] = None,
    has_speaker: bool = False,
    has_instruct: bool = False,
    donate: bool = True,
    draft_fn: Callable[[SpecState, int], jax.Array] = repeat_draft,
    force_accept: bool = False,
) -> SpecGenerateFns:
    """Jitted speculative prefill / decode for `batch` streams.

    A decode dispatch runs `num_iters` iterations and commits between
    `num_iters` and `num_iters * k` frames per stream.  ``force_accept``
    is the benchmark-only structural full-acceptance probe (see
    `_spec_iteration`); production callers never set it.
    """
    from ..models.talker import talker_init_cache

    def prefill_impl(params, text_ids, text_len, key, sp, speaker_embed=None,
                     instruct_ids=None, instruct_len=None):
        bundle = build_prompt(
            params["embeddings"], text_ids, text_len, lang_id,
            speaker_embed if has_speaker else None,
            instruct_ids if has_instruct else None,
            instruct_len if has_instruct else None,
        )
        cache = talker_init_cache(cfg.talker, batch, max_len)
        state, frame0, valid0 = init_spec_state(
            cfg, params, bundle, cache, key, sp
        )
        return state, bundle, frame0, valid0

    def decode_impl(params, state, trailing, trailing_len, tts_pad_embed, sp):
        return decode_frames_spec(
            cfg, params, state, trailing, trailing_len, tts_pad_embed, sp,
            k, num_iters, draft_fn, force_accept=force_accept,
        )

    return SpecGenerateFns(
        prefill=jax.jit(prefill_impl),
        decode=jax.jit(decode_impl, donate_argnums=(1,) if donate else ()),
    )
