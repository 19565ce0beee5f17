#!/usr/bin/env python3
"""Drive the main path once on an NVIDIA GPU and check it against the plain
float32 reference (leaxer_qwen3_tts_tpu/models/reference.py).

    python chip_smoke.py              # one GPU: both presets at published widths
    python chip_smoke.py --four-gpus  # four GPUs of one host: the tensor-parallel
                                      # engine and the TP x DP train step, each
                                      # against the same work on one GPU

Weights are random, made on the device from a fixed seed; real weights are not
in the repository.  One GPU runs these phases, each raising on failure:

  correctness  0.6B and 1.7B: prefill + 16 teacher-forced decode steps (talker
               logits), one frame of MTP logits and one vocoder chunk, against
               the reference.  f32 params under "highest" precision: relative
               L-inf <= 1e-3.  Served dtypes (bf16; int8 weights; int8 weights
               with int8 KV) against the reference on the same rounded weights:
               relative L2 <= 2e-2 (4e-2 with int8 KV).
  train        three train steps at the 0.6B width: losses finite, decreasing.
  spec         0.6B in float32: spec_k=4 greedy == sequential greedy.
  engine       0.6B bf16, then int8 weights + int8 KV: synthesize, streaming
               (same codes as synthesize), voice clone, preset speaker,
               spec_k=4 greedy beside sequential greedy.
  pool         the continuous batcher: 8 requests on 4 slots, then one
               streamed request beside 3 co-tenants.
  cli          a saved 0.6B checkpoint through the CLI, in this process.
  1.7b         one synthesize request.

The script exits non-zero, and prints no result, when JAX finds no GPU.  Its
last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Everything runs in one process: a second JAX process on the card would fail
for want of memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

from leaxer_qwen3_tts_tpu.api.engine import TTSEngine
from leaxer_qwen3_tts_tpu.config import QWEN3_TTS_06B, QWEN3_TTS_17B, TTSModelConfig
from leaxer_qwen3_tts_tpu.models import reference
from leaxer_qwen3_tts_tpu.models.code_predictor import mtp_chain
from leaxer_qwen3_tts_tpu.models.codec12hz import vocode_chunk
from leaxer_qwen3_tts_tpu.models.layers import transformer_forward
from leaxer_qwen3_tts_tpu.models.talker import (
    talker_decode_step,
    talker_init_cache,
    talker_prefill,
)
from leaxer_qwen3_tts_tpu.ops.quant import dense, fuse_params, quantize_params
from leaxer_qwen3_tts_tpu.runtime.weights import init_params
from leaxer_qwen3_tts_tpu.utils.compile_cache import enable_compile_cache
from leaxer_qwen3_tts_tpu.utils.gpu import nvidia_smi, require_gpu

REPO = os.path.dirname(os.path.abspath(__file__))

# Gates.  f32: both sides f32 at "highest" precision, so only summation order
# differs.  Served dtypes: the path keeps activations in bf16 while the
# reference stays f32 on the same weight values; bf16 rounding alone puts a
# 28-layer stack near 1.6% relative L2.  Under kv_quant the path quantises
# K/V computed in bf16 and the reference quantises its f32 K/V: wherever the
# two straddle a rounding boundary they land one int8 step apart, which adds
# about as much again, hence the wider gate for that variant.
F32_REL_LINF = 1e-3
SERVED_REL_L2 = 2e-2
SERVED_KVQ_REL_L2 = 4e-2
# synthesize vs synthesize_stream: the same codes, vocoded whole vs in chunks
# with left context.  The vocoder runs in bf16 and the two programs convolve
# different lengths, so the GPU may pick other algorithms and round
# differently: the served bound applies, not bit equality.
STREAM_REL_L2 = 2e-2
MESH_REL_L2 = 1e-2  # four-GPU tensor-parallel logits vs one GPU
MESH_LOSS_RTOL = 1e-2  # four-GPU TP x DP losses vs one GPU

TEXT = "hello world, this is a smoke test of the speech path."


class SmokeError(AssertionError):
    """A phase's check failed."""


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# ---------------------------------------------------------------------------
# Configurations and weights
# ---------------------------------------------------------------------------


def with_dtype(cfg: TTSModelConfig, dtype: str) -> TTSModelConfig:
    """The same model with its talker, MTP and vocoder weights in ``dtype``."""
    r = dataclasses.replace
    return r(
        cfg,
        talker=r(cfg.talker, transformer=r(cfg.talker.transformer, dtype=dtype)),
        code_predictor=r(
            cfg.code_predictor,
            transformer=r(cfg.code_predictor.transformer, dtype=dtype),
        ),
        vocoder=r(cfg.vocoder, dtype=dtype),
    )


def with_kv_quant(cfg: TTSModelConfig) -> TTSModelConfig:
    r = dataclasses.replace
    return r(cfg, talker=r(cfg.talker, transformer=r(
        cfg.talker.transformer, kv_cache_quant=True)))


def make_params(cfg: TTSModelConfig, seed: int, device=None) -> dict:
    """Random weights made on the device op by op.  Jitting the whole init
    would compile one random-number kernel per leaf (minutes on the GPU);
    op by op, the layers' repeated shapes share their compiled kernels."""
    with jax.default_device(device or jax.devices()[0]):
        return init_params(cfg, jax.random.PRNGKey(seed))


def as_config_dtypes(cfg: TTSModelConfig, params: dict) -> dict:
    """``params`` cast leaf by leaf to the dtypes ``init_params(cfg)`` makes
    (the served model from the float32 one, without a second init)."""
    like = jax.eval_shape(lambda k: init_params(cfg, k), jax.random.PRNGKey(0))
    return jax.tree.map(lambda x, s: x.astype(s.dtype), params, like)


def cast_params(params: dict, dtype) -> dict:
    return jax.tree.map(
        lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        params,
    )


def served_params(params: dict, quantize=None) -> dict:
    """The engine's single-device weight transforms: concatenated qkv / gate-up
    layout, then optional weight-only quantisation."""
    p = fuse_params(params)
    if quantize is not None:
        p = quantize_params(p, bits={"int8": 8, "int4": 4}[quantize])
    return p


def rel_linf(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# The serving path beside the reference
# ---------------------------------------------------------------------------


def talker_path_logits(cfg, params, prompt, prompt_len, steps, max_len,
                       k: int = 1, uniform_fill: bool = True):
    """Serving path: prefill, then ``steps`` fed k tokens per forward through
    the static KV cache (k=1: talker_decode_step; k>1: the S=k verify pass).

    Returns logits [B, 1 + N, V]: after the prompt's last real token, then
    after each step token."""
    tcfg = cfg.talker
    B, N = steps.shape[0], steps.shape[1]

    def run(params, prompt, prompt_len, steps):
        cache = talker_init_cache(tcfg, B, max_len)
        lg0, _, cache, valid = talker_prefill(tcfg, params, prompt, prompt_len, cache)

        def body(carry, x):  # x [B, k, H]
            cache, valid, pos = carry
            if k == 1:
                lg, _, cache, valid = talker_decode_step(
                    tcfg, params, x[:, 0], pos, cache, valid,
                    uniform_fill=uniform_fill,
                )
                lg = lg[:, None]
            else:
                positions = pos[:, None] + jnp.arange(k, dtype=jnp.int32)[None]
                hidden, cache, valid = transformer_forward(
                    tcfg.transformer, params["transformer"], x, positions,
                    cache, valid, uniform_fill=uniform_fill,
                )
                lg = dense(hidden, params["lm_head"])
            return (cache, valid, pos + k), lg

        xs = jnp.moveaxis(steps.reshape(B, N // k, k, -1), 1, 0)
        (cache, _, _), lgs = jax.lax.scan(body, (cache, valid, prompt_len), xs)
        lgs = jnp.moveaxis(lgs, 0, 1).reshape(B, N, -1)
        return jnp.concatenate([lg0[:, None], lgs], axis=1), cache

    return jax.jit(run)(params, prompt, prompt_len, steps)


def talker_reference_logits(cfg, ref_params, prompt, prompt_len, steps,
                            kv_int8: bool = False):
    """The reference over [prompt (right-padded), steps], read at the same
    positions as :func:`talker_path_logits`."""
    B, P = prompt.shape[:2]
    N = steps.shape[1]
    seq = jnp.concatenate([prompt, steps], axis=1).astype(jnp.float32)
    valid = jnp.concatenate(
        [jnp.arange(P)[None] < prompt_len[:, None], jnp.ones((B, N), bool)], axis=1
    )
    lg = jax.jit(reference.talker_logits, static_argnums=(0, 4))(
        cfg.talker, ref_params["talker"], seq, valid, kv_int8
    )
    last = jnp.take_along_axis(lg, (prompt_len - 1)[:, None, None], axis=1)
    return jnp.concatenate([last, lg[:, P:]], axis=1)


def mtp_path_logits(cfg, params, last_hidden, code0_embed):
    """Greedy MTP chain for one frame: (subcodes [B, n], logits [B, n, V])."""
    ccfg = cfg.code_predictor

    def run(p, emb, lh, c0):
        greedy = lambda key, lg: jnp.argmax(lg, axis=-1).astype(jnp.int32)
        subs, _, logits = mtp_chain(
            ccfg, p, emb["pred_embed"], lh, c0, jax.random.PRNGKey(0), greedy
        )
        return subs, logits

    return jax.jit(run)(params["code_predictor"], params["embeddings"],
                        last_hidden, code0_embed)


def mtp_reference_logits(cfg, ref_params, last_hidden, code0_embed, subcodes):
    return jax.jit(reference.mtp_logits, static_argnums=0)(
        cfg.code_predictor, ref_params["code_predictor"],
        ref_params["embeddings"]["pred_embed"],
        last_hidden.astype(jnp.float32), code0_embed.astype(jnp.float32), subcodes,
    )


def vocoder_pair(cfg, params, ref_params, codes, context: int):
    """One streamed vocoder chunk (the last F - context frames of ``codes``
    decoded with ``context`` frames of left context) and the reference's
    whole-utterance audio over the same samples."""
    vcfg = cfg.vocoder
    path = jax.jit(vocode_chunk, static_argnums=(0, 3))(
        vcfg, params["vocoder"], codes, context
    )
    ref = jax.jit(reference.vocoder, static_argnums=0)(vcfg, ref_params["vocoder"], codes)
    return path, ref[:, context * vcfg.samples_per_frame :]


def correctness(label: str, cfg32: TTSModelConfig, params32: dict, *,
                batch: int = 1, prompt_lens=None, n_steps: int = 16,
                max_len=None, verify_k: int = 1, uniform_fill: bool = True,
                variants=("f32", "bf16", "int8", "int8+kvq"),
                served_dtype: str = "bfloat16", vocoder_frames: int = 8,
                seed: int = 0) -> dict:
    """Compare the serving path with the reference for each variant.

    ``cfg32``/``params32`` are the model in float32.  Variants: "f32" (gate
    rel L-inf <= F32_REL_LINF under "highest" precision) and the served dtypes
    "bf16", "int8", "int4" and "int8+kvq" (gate rel L2 <= SERVED_REL_L2, the
    reference on the served weights' values; ``served_dtype`` is the dtype
    the quantised variants start from).  Returns the measured numbers."""
    H = cfg32.talker.hidden_size
    P = 12
    prompt_lens = prompt_lens or [P] * batch
    max_len = max_len or P + n_steps + verify_k
    rng = np.random.default_rng(seed)
    prompt = jnp.asarray(rng.standard_normal((batch, P, H)) * 0.02, jnp.float32)
    steps = jnp.asarray(rng.standard_normal((batch, n_steps, H)) * 0.02, jnp.float32)
    plen = jnp.asarray(prompt_lens, jnp.int32)
    lh = jnp.asarray(rng.standard_normal((batch, H)), jnp.float32)
    c0 = jnp.asarray(rng.standard_normal((batch, H)) * 0.02, jnp.float32)
    ctx = cfg32.vocoder.left_context_frames
    codes = jnp.asarray(
        rng.integers(0, cfg32.vocoder.codebook_size, (1, ctx + vocoder_frames, 16)),
        jnp.int32,
    )
    results = {}
    for variant in variants:
        t0 = time.perf_counter()
        quant = {"int8": "int8", "int8+kvq": "int8", "int4": "int4"}.get(variant)
        dtype = {"f32": "float32", "bf16": "bfloat16"}.get(variant, served_dtype)
        cfg = with_dtype(cfg32, dtype)
        if variant == "int8+kvq":
            cfg = with_kv_quant(cfg)
        params = cast_params(params32, jnp.float32 if dtype == "float32" else jnp.bfloat16)
        params = served_params(params, quant)
        ref_params = reference.dequantize(params)
        dt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        precision = "highest" if variant == "f32" else "default"
        with jax.default_matmul_precision(precision):
            t_path, _ = talker_path_logits(
                cfg, params["talker"], prompt.astype(dt), plen,
                steps.astype(dt), max_len, k=verify_k, uniform_fill=uniform_fill,
            )
            subs, m_path = mtp_path_logits(cfg, params, lh.astype(dt), c0.astype(dt))
            v_path = None
            if quant is None:
                v_path, v_ref = vocoder_pair(cfg, params, ref_params, codes, ctx)
        t_ref = talker_reference_logits(
            cfg, ref_params, prompt.astype(dt), plen, steps.astype(dt),
            kv_int8=variant == "int8+kvq",
        )
        m_ref = mtp_reference_logits(cfg, ref_params, lh.astype(dt), c0.astype(dt), subs)
        pairs = {"talker": (t_path, t_ref), "mtp": (m_path, m_ref)}
        if v_path is not None:
            pairs["vocoder"] = (v_path, v_ref)
        out = {}
        for name, (a, b) in pairs.items():
            a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
            check(np.isfinite(a).all(), f"{label} {variant} {name}: non-finite output")
            check(a.shape == b.shape, f"{label} {variant} {name}: shape {a.shape} != {b.shape}")
            if variant == "f32":
                err = rel_linf(a, b)
                out[name] = {"rel_linf": err}
                check(err <= F32_REL_LINF,
                      f"{label} f32 {name}: rel L-inf {err:.3e} > {F32_REL_LINF}")
            else:
                err = rel_l2(a, b)
                out[name] = {"rel_l2": err}
                bound = SERVED_KVQ_REL_L2 if variant == "int8+kvq" else SERVED_REL_L2
                check(err <= bound,
                      f"{label} {variant} {name}: rel L2 {err:.3e} > {bound}")
        # not gated: code0 argmax agreement, and f32 under default precision
        agree = float(np.mean(np.argmax(np.asarray(t_path), -1) == np.argmax(np.asarray(t_ref), -1)))
        out["talker"]["code0_argmax_agree"] = agree
        if variant == "f32":
            t_def, _ = talker_path_logits(
                cfg, params["talker"], prompt, plen, steps, max_len, k=verify_k,
                uniform_fill=uniform_fill,
            )
            out["talker"]["rel_linf_default_precision"] = rel_linf(t_def, t_ref)
        out["seconds"] = time.perf_counter() - t0
        results[variant] = out
        log(f"correctness {label} {variant}: {json.dumps(out, sort_keys=True)}")
        del params, ref_params
    return results


# ---------------------------------------------------------------------------
# Engine, pool, CLI, training
# ---------------------------------------------------------------------------


def write_tiny_vocab(directory: str):
    """A byte-level BPE vocab (256 byte tokens and a few merges): enough for
    the tokenizer to run; real Qwen3 vocab files are not in the repository."""
    from leaxer_qwen3_tts_tpu.frontend._bpe_py import byte_to_proxy

    proxy = byte_to_proxy()
    tokens = [proxy[b] for b in range(256)]
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"), ("Ġ", "w"),
              ("o", "r"), ("Ġw", "or"), ("l", "d"), ("Ġwor", "ld")]
    tokens += [a + b for a, b in merges]
    vocab_path = os.path.join(directory, "vocab.json")
    merges_path = os.path.join(directory, "merges.txt")
    with open(vocab_path, "w") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f, ensure_ascii=True)
    with open(merges_path, "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return vocab_path, merges_path


def write_reference_wav(path: str, seconds: float = 3.0) -> None:
    """A synthetic voice-like reference clip for the clone path."""
    from leaxer_qwen3_tts_tpu.frontend import write_wav

    t = np.arange(int(24000 * seconds)) / 24000.0
    f0 = 140.0 + 20.0 * np.sin(2 * np.pi * 3.0 * t)
    wave = sum(np.sin(2 * np.pi * h * np.cumsum(f0) / 24000.0) / h for h in (1, 2, 3))
    write_wav(path, (0.3 * wave * (0.6 + 0.4 * np.sin(2 * np.pi * 2.0 * t))).astype(np.float32))


def _summary(r) -> dict:
    m = r.metrics
    check(m.frames > 0, "no frames generated")
    check(np.isfinite(r.audio).all(), "non-finite audio")
    check(r.audio.size == m.frames * 2000, f"audio {r.audio.size} != frames {m.frames} x 2000")
    return {"frames": m.frames, "rtf": m.rtf, "ttfa_s": m.ttfa_seconds,
            "total_s": m.total_seconds, "finite": True}


def engine_phase(label: str, cfg, params, tokenizer, wav_path: str, *,
                 quantize=None, kv_quant: bool = False, max_tokens: int = 32,
                 max_frames: int = 48, chunk_len: int = 16,
                 first_chunk_len: int = 4, spec_must_equal: bool = True) -> dict:
    """synthesize, synthesize_stream (same codes, audio within
    STREAM_REL_L2), clone, preset speaker, and spec_k=4 greedy against
    sequential greedy, on one engine config."""
    kw = dict(config=cfg, params=params, tokenizer=tokenizer, max_frames=max_frames,
              chunk_len=chunk_len, first_chunk_len=first_chunk_len, kv_buckets=(),
              quantize=quantize, kv_quant=kv_quant)
    eng = TTSEngine(**kw)
    check(eng.is_ready(), f"{label}: engine not ready: {eng.get_error()}")
    out = {}
    sk = dict(temperature=0.0, max_tokens=max_tokens, seed=0)
    r = eng.synthesize(TEXT, **sk)
    out["synthesize"] = _summary(r)

    items = list(eng.synthesize_stream(TEXT, **sk))
    streamed, final = items[:-1], items[-1]
    check(len(streamed) >= 2, f"{label}: stream gave {len(streamed)} chunk(s)")
    audio = np.concatenate(streamed)
    check(np.array_equal(final.codes, r.codes), f"{label}: stream codes != offline codes")
    check(audio.shape == r.audio.shape,
          f"{label}: streamed {audio.shape} samples vs offline {r.audio.shape}")
    err = rel_l2(audio, r.audio)
    check(err <= STREAM_REL_L2, f"{label}: streamed audio rel L2 {err:.3e} > {STREAM_REL_L2}")
    out["stream"] = {"chunks": len(streamed), "rel_l2_vs_offline": err,
                     "max_abs_diff_vs_offline": float(np.abs(audio - r.audio).max()),
                     "ttfa_s": final.metrics.ttfa_seconds}

    out["clone"] = _summary(eng.synthesize_clone(TEXT, wav_path, **sk))
    out["speaker"] = _summary(eng.synthesize_speaker(TEXT, "vivian", **sk))
    out["spec_k4"] = spec_vs_sequential(label, kw, r, sk, must_equal=spec_must_equal)
    log(f"engine {label}: {json.dumps(out, sort_keys=True, default=float)}")
    return out


def spec_vs_sequential(label: str, engine_kw: dict, seq, sk: dict, *,
                       must_equal: bool = True) -> dict:
    """spec_k=4 greedy against the sequential greedy result ``seq``.

    Greedy speculative decoding keeps exactly the frames sequential decoding
    makes.  The verify pass multiplies K rows where the sequential step
    multiplies one, so on the GPU the two may round differently; in bf16
    that can flip a near-tied argmax, hence ``must_equal=False`` there
    (reported, not gated) and the gated check in float32."""
    spec = TTSEngine(**engine_kw, spec_k=4)
    check(spec.is_ready(), f"{label}: spec engine not ready: {spec.get_error()}")
    rs = spec.synthesize(TEXT, **sk)
    same = np.array_equal(rs.codes, seq.codes)
    n = min(len(rs.codes), len(seq.codes))
    first_diff = next((i for i in range(n) if not np.array_equal(rs.codes[i], seq.codes[i])), None)
    out = {**_summary(rs), "equals_sequential": same, "first_differing_frame": first_diff,
           "accepted": rs.metrics.spec_accepted}
    if must_equal:
        check(same, f"{label}: spec_k=4 greedy codes differ from sequential (first "
                    f"differing frame {first_diff}, lengths {len(rs.codes)} vs {len(seq.codes)})")
    return out


def spec_exact_phase(cfg32, params32, tokenizer, *, max_tokens: int = 32,
                     max_frames: int = 48) -> dict:
    """spec_k=4 greedy == sequential greedy, float32 at "highest" precision."""
    kw = dict(config=cfg32, params=params32, tokenizer=tokenizer, max_frames=max_frames,
              chunk_len=16, first_chunk_len=4, kv_buckets=())
    sk = dict(temperature=0.0, max_tokens=max_tokens, seed=0)
    with jax.default_matmul_precision("highest"):
        seq = TTSEngine(**kw)
        check(seq.is_ready(), f"f32 engine not ready: {seq.get_error()}")
        out = spec_vs_sequential("f32", kw, seq.synthesize(TEXT, **sk), sk)
    log(f"spec f32: {json.dumps(out, sort_keys=True, default=float)}")
    return out


def pool_phase(engine, *, requests: int = 8, slots: int = 4, max_tokens: int = 24) -> dict:
    """The continuous batcher: ``requests`` requests on ``slots`` slots, then a
    streamed request beside slots-1 co-tenants."""
    from leaxer_qwen3_tts_tpu.serve import ContinuousBatcher

    pool = ContinuousBatcher(engine, pool_size=slots, chunk_len=8, kv_bucket=128,
                             text_bucket_max=64)
    try:
        t0 = time.perf_counter()
        futs = [pool.submit(f"{TEXT} number {i}", temperature=0.8, seed=i,
                            max_tokens=max_tokens) for i in range(requests)]
        res = [f.result(timeout=600) for f in futs]
        for r in res:
            check(np.isfinite(r.audio).all() and r.audio.size > 0, "pool: bad audio")
        batch_s = time.perf_counter() - t0
        audio_s = sum(r.audio.size for r in res) / 24000.0
        co = [pool.submit(f"co-tenant {i}", temperature=0.8, seed=100 + i,
                          max_tokens=2 * max_tokens) for i in range(slots - 1)]
        h = pool.submit_stream(TEXT, temperature=0.7, seed=11, max_tokens=max_tokens)
        items = list(h)
        chunks, result = items[:-1], items[-1]
        check(len(chunks) >= 1, "pool: stream gave no incremental audio")
        check(np.array_equal(np.concatenate(chunks), result.audio),
              "pool: streamed concatenation != retired audio")
        check(np.isfinite(result.audio).all(), "pool: non-finite streamed audio")
        for f in co:
            check(np.isfinite(f.result(timeout=600).audio).all(), "pool: bad co-tenant audio")
        out = {"requests": requests, "slots": slots, "wall_s": batch_s,
               "aggregate_rtf": audio_s / batch_s, "stream_chunks": len(chunks),
               "stream_ttfa_s": result.metrics.ttfa_seconds}
    finally:
        pool.shutdown()
    log(f"pool: {json.dumps(out, sort_keys=True, default=float)}")
    return out


def cli_phase(cfg, params, vocab_files, workdir: str, max_tokens: int = 24) -> dict:
    """Save a checkpoint and run the CLI on it in this process."""
    from leaxer_qwen3_tts_tpu.cli.main import main as cli_main
    from leaxer_qwen3_tts_tpu.frontend import read_wav
    from leaxer_qwen3_tts_tpu.runtime.weights import save_checkpoint

    ckpt = os.path.join(workdir, "ckpt")
    save_checkpoint(ckpt, cfg, params)
    for f in vocab_files:
        shutil.copy(f, ckpt)
    wav = os.path.join(workdir, "cli_out.wav")
    rc = cli_main(["-m", ckpt, "-p", TEXT, "-o", wav, "--temp", "0",
                   "--max-tokens", str(max_tokens)])
    check(rc == 0, f"cli: exit code {rc}")
    audio, sr = read_wav(wav)
    check(sr == 24000 and audio.size > 0 and np.isfinite(audio).all(),
          f"cli: bad WAV (sr={sr}, samples={audio.size})")
    out = {"rc": rc, "samples": int(audio.size), "sample_rate": sr}
    log(f"cli: {json.dumps(out)}")
    return out


def train_batch(seed: int = 0, B: int = 2, T: int = 16, F: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "text_ids": jnp.asarray(rng.integers(0, 1000, (B, T)), jnp.int32),
        "text_len": jnp.asarray(rng.integers(4, T + 1, (B,)), jnp.int32),
        "codes": jnp.asarray(rng.integers(0, 2048, (B, F, 16)), jnp.int32),
        "num_frames": jnp.asarray(rng.integers(2, F, (B,)), jnp.int32),
    }


def train_losses(cfg, params, batch, steps: int = 3, mesh=None):
    """(losses, final state) of ``steps`` AdamW steps on one fixed batch
    (sharded over ``mesh`` when given)."""
    from leaxer_qwen3_tts_tpu.training import (
        batch_sharding,
        init_train_state,
        make_optimizer,
        make_train_step,
        shard_train_state,
    )

    tx = make_optimizer(learning_rate=1e-4)
    state = init_train_state(params, tx)
    step = make_train_step(cfg, tx, donate=False)
    losses = []
    if mesh is not None:
        with jax.set_mesh(mesh):
            state = shard_train_state(mesh, state, tx)
            batch = jax.device_put(batch, batch_sharding(mesh))
            for _ in range(steps):
                state, m = step(state, batch)
                losses.append(float(m.loss))
    else:
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m.loss))
    return losses, state


def train_phase(cfg32, params32, steps: int = 3) -> dict:
    losses, _ = train_losses(cfg32, params32, train_batch(), steps)
    check(all(np.isfinite(losses)), f"train: non-finite losses {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])), f"train: losses not decreasing {losses}")
    log(f"train: losses {losses}")
    return {"losses": losses}


# ---------------------------------------------------------------------------
# Four GPUs
# ---------------------------------------------------------------------------


def _spread(x) -> int:
    """Number of devices holding a part of ``x``."""
    return len(x.sharding.device_set)


def four_gpu_engine_phase(cfg32, params32, devices, n_steps: int = 16) -> dict:
    """The engine under a TP=4 mesh against the same request on one GPU.

    In float32 at "highest" precision: the sharded matmuls sum their parts
    in another order, and in bf16 that rounding alone would sit near the
    gate, which is there to catch a wrong split, not rounding."""
    with jax.default_matmul_precision("highest"):
        return _four_gpu_engine(cfg32, params32, devices, n_steps)


def _four_gpu_engine(cfg, params, devices, n_steps):
    from leaxer_qwen3_tts_tpu.parallel import make_mesh

    mesh = make_mesh(data=1, model=4, devices=devices[:4])
    one = TTSEngine(config=cfg, params=params, max_frames=48, chunk_len=16,
                    first_chunk_len=4, kv_buckets=(), fuse=False)
    tp = TTSEngine(config=cfg, params=params, max_frames=48, chunk_len=16,
                   first_chunk_len=4, kv_buckets=(), mesh=mesh)
    check(one.is_ready() and tp.is_ready(), f"engines not ready: {one.get_error()} {tp.get_error()}")
    wq = tp.params["talker"]["transformer"]["layers"]["wq"]
    check(_spread(wq) == 4 and wq.addressable_shards[0].data.shape[-1] * 4 == wq.shape[-1],
          f"four-gpu: talker wq not split over 4 GPUs ({wq.sharding})")
    H, dt = cfg.talker.hidden_size, cfg.talker.transformer.jnp_dtype
    rng = np.random.default_rng(0)
    prompt = jnp.asarray(rng.standard_normal((1, 12, H)) * 0.02, dt)
    steps = jnp.asarray(rng.standard_normal((1, n_steps, H)) * 0.02, dt)
    plen = jnp.asarray([12], jnp.int32)
    ref, _ = talker_path_logits(cfg, one.params["talker"], prompt, plen, steps, 12 + n_steps + 1)
    with jax.set_mesh(mesh):
        got, cache = talker_path_logits(cfg, tp.params["talker"], prompt, plen, steps,
                                        12 + n_steps + 1)
    check(_spread(cache.k) == 4, f"four-gpu: KV cache on {_spread(cache.k)} GPU(s)")
    kshard = cache.k.addressable_shards[0].data.shape
    check(kshard[2] * 4 == cache.k.shape[2], f"four-gpu: KV heads not split ({kshard} of {cache.k.shape})")
    err = rel_l2(got, ref)
    check(err <= MESH_REL_L2, f"four-gpu: TP logits rel L2 {err:.3e} > {MESH_REL_L2}")
    r = tp.synthesize_tokens([5] * 20, temperature=0.0, max_tokens=24)
    check(r.metrics.frames > 0 and np.isfinite(r.audio).all(), "four-gpu: bad TP synthesis")
    out = {"mesh": dict(mesh.shape), "logits_rel_l2_vs_one_gpu": err,
           "wq_devices": _spread(wq), "kv_devices": _spread(cache.k),
           "kv_shard_shape": list(kshard), "kv_shape": list(cache.k.shape),
           "logits_devices": _spread(got), "tp_synthesis_frames": r.metrics.frames}
    log(f"four-gpu engine: {json.dumps(out, sort_keys=True, default=float)}")
    return out


def four_gpu_train_phase(cfg32, params32, devices) -> dict:
    """The TP x DP train step on a data=2 x model=2 mesh against one GPU."""
    from leaxer_qwen3_tts_tpu.parallel import make_mesh

    batch = train_batch()
    one, _ = train_losses(cfg32, params32, batch)
    mesh = make_mesh(data=2, model=2, devices=devices[:4])
    got, state = train_losses(cfg32, params32, batch, mesh=mesh)
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, one))
    check(worst <= MESH_LOSS_RTOL, f"four-gpu train: losses {got} vs one GPU {one}")
    wq = state.params["talker"]["transformer"]["layers"]["wq"]
    check(_spread(wq) == 4, f"four-gpu train: talker wq on {_spread(wq)} GPU(s)")
    out = {"mesh": dict(mesh.shape), "losses": got, "one_gpu_losses": one,
           "max_rel_diff": worst, "wq_devices": _spread(wq),
           "wq_shard_shape": list(wq.addressable_shards[0].data.shape),
           "wq_shape": list(wq.shape)}
    log(f"four-gpu train: {json.dumps(out, sort_keys=True)}")
    return out


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------


def _timed(name: str, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"phase {name} passed in {time.perf_counter() - t0:.1f} s")
    return out


def run_one_gpu(workdir: str) -> None:
    from leaxer_qwen3_tts_tpu.config import PRESET_SPEAKERS
    from leaxer_qwen3_tts_tpu.frontend import Tokenizer

    vocab = write_tiny_vocab(workdir)
    tok = Tokenizer(*vocab)
    wav = os.path.join(workdir, "reference.wav")
    write_reference_wav(wav)

    # 0.6B: the float32 model for the reference checks, training and the
    # float32 spec check; the served bf16 model is the same weights cast.
    cfg32 = with_dtype(QWEN3_TTS_06B, "float32")
    p32 = _timed("init 0.6b", make_params, cfg32, seed=0)
    _timed("correctness 0.6b", correctness, "0.6b", cfg32, p32)
    _timed("train", train_phase, cfg32, p32)
    _timed("spec f32 0.6b", spec_exact_phase, cfg32, p32, tok)
    params = as_config_dtypes(QWEN3_TTS_06B, p32)
    del p32
    H = QWEN3_TTS_06B.talker.hidden_size
    params["speaker_table"] = jax.random.normal(
        jax.random.PRNGKey(2), (len(PRESET_SPEAKERS), H), jnp.float32) * 0.02
    _timed("engine 0.6b bf16", engine_phase, "0.6b bf16", QWEN3_TTS_06B, params, tok, wav,
           spec_must_equal=False)
    _timed("engine 0.6b int8+kvq", engine_phase, "0.6b int8+kvq", QWEN3_TTS_06B, params,
           tok, wav, quantize="int8", kv_quant=True, spec_must_equal=False)
    eng = TTSEngine(config=QWEN3_TTS_06B, params=params, tokenizer=tok, max_frames=48,
                    chunk_len=16, first_chunk_len=4, kv_buckets=())
    _timed("pool", pool_phase, eng)
    del eng
    _timed("cli", cli_phase, QWEN3_TTS_06B, params, vocab, workdir)
    del params

    cfg32 = with_dtype(QWEN3_TTS_17B, "float32")
    p32 = _timed("init 1.7b", make_params, cfg32, seed=3)
    _timed("correctness 1.7b", correctness, "1.7b", cfg32, p32)
    p17 = as_config_dtypes(QWEN3_TTS_17B, p32)
    del p32
    eng17 = TTSEngine(config=QWEN3_TTS_17B, params=p17, tokenizer=tok, max_frames=48,
                      chunk_len=16, first_chunk_len=4, kv_buckets=())
    r = _timed("1.7b synthesize", eng17.synthesize, TEXT, temperature=0.0, max_tokens=32)
    log(f"1.7b synthesize: {json.dumps(_summary(r), default=float)}")


def run_four_gpus(devices) -> None:
    cfg17 = with_dtype(QWEN3_TTS_17B, "float32")
    p17 = make_params(cfg17, seed=3, device=devices[0])
    _timed("four-gpu engine 1.7b", four_gpu_engine_phase, cfg17, p17, devices)
    del p17
    cfg32 = with_dtype(QWEN3_TTS_06B, "float32")
    p32 = make_params(cfg32, seed=0, device=devices[0])
    _timed("four-gpu train 0.6b", four_gpu_train_phase, cfg32, p32, devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-GPU phases (needs four GPUs)")
    args = ap.parse_args(argv)

    devices = jax.devices()
    require_gpu(devices, 4 if args.four_gpus else 1, who="chip_smoke")
    d0 = devices[0]
    log(f"device: {d0.device_kind} x {len(devices)} ({d0.platform})")
    log(f"nvidia-smi: {nvidia_smi()}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.four_gpus:
        run_four_gpus(devices)
    else:
        workdir = tempfile.mkdtemp(prefix=".smoke_", dir=REPO)
        try:
            run_one_gpu(workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
