#!/usr/bin/env python3
"""Headline benchmark on one NVIDIA GPU: real-time factor of Qwen3-TTS.

Measures the generation path (prefill -> chunked talker + MTP decode ->
vocoder) on random weights made on the device from a seed (timing does not
depend on weight values), with EOS suppressed so every run decodes the same
number of frames.  Prints the card's name and power limit on stderr, then ONE
JSON line on stdout.  Stops when JAX finds no GPU: no number here comes from
another device.

Env knobs: BENCH_MODEL (0.6b | 1.7b), BENCH_FRAMES (384), BENCH_BATCH (1),
BENCH_CHUNK (96), BENCH_TTFA_CHUNK (8), BENCH_QUANT (int8 | none),
BENCH_KV_QUANT (0 | 1), and BENCH_SKIP_{SERVING,BF16,LONGFORM,KVQ,SPEC}=1 to
leave an arm out.
"""

import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def timed(fn, *args):
    """(result, seconds), the clock stopped only once the device is done."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def main() -> None:
    from leaxer_qwen3_tts_tpu.config import FRAME_RATE, QWEN3_TTS_06B, QWEN3_TTS_17B
    from leaxer_qwen3_tts_tpu.models.codec12hz import vocoder_forward
    from leaxer_qwen3_tts_tpu.ops.quant import fuse_params, quantize_params
    from leaxer_qwen3_tts_tpu.runtime.generate import make_generate_fns
    from leaxer_qwen3_tts_tpu.runtime.sampling import SamplingParams
    from leaxer_qwen3_tts_tpu.runtime.speculative import make_spec_generate_fns
    from leaxer_qwen3_tts_tpu.runtime.weights import init_params
    from leaxer_qwen3_tts_tpu.utils.compile_cache import enable_compile_cache
    from leaxer_qwen3_tts_tpu.utils.gpu import nvidia_smi, require_gpu

    require_gpu(jax.devices(), who="bench")
    dev = jax.devices()[0]
    card = nvidia_smi().splitlines()[0]
    log(f"bench: {dev.device_kind} x {len(jax.devices())}; nvidia-smi: {card}")
    enable_compile_cache()

    frames = int(os.environ.get("BENCH_FRAMES", "384"))
    batch = int(os.environ.get("BENCH_BATCH", "1"))
    chunk = int(os.environ.get("BENCH_CHUNK", "96"))
    ttfa_chunk = int(os.environ.get("BENCH_TTFA_CHUNK", "8"))
    frames = max(chunk, (frames // chunk) * chunk)
    n_chunks = frames // chunk
    model = os.environ.get("BENCH_MODEL", "0.6b")
    quant = os.environ.get("BENCH_QUANT", "int8")
    kv_quant = os.environ.get("BENCH_KV_QUANT", "0") == "1"
    skip = lambda arm: os.environ.get(f"BENCH_SKIP_{arm}") == "1"  # noqa: E731

    cfg = QWEN3_TTS_17B if model == "1.7b" else QWEN3_TTS_06B

    def with_kvq(c):
        r = dataclasses.replace
        return r(c, talker=r(c.talker, transformer=r(c.talker.transformer,
                                                       kv_cache_quant=True)))

    cfg_f32kv = cfg
    if kv_quant:
        cfg = with_kvq(cfg)

    # on-device init op by op (a jitted init compiles one random kernel per
    # leaf); the engine's layout and quantisation after it
    t0 = time.perf_counter()
    bf16_params = jax.block_until_ready(fuse_params(
        init_params(cfg, jax.random.PRNGKey(0), with_speaker_encoder=False)))
    params = bf16_params
    if quant == "int8":
        params = jax.block_until_ready(jax.jit(quantize_params)(bf16_params))
    init_s = time.perf_counter() - t0
    log(f"init {model} params (quant={quant}): {init_s:.1f}s")

    T = 16
    ids = jnp.full((batch, T), 100, jnp.int32)
    lens = jnp.full((batch,), T, jnp.int32)
    key = jax.random.PRNGKey(1)
    sp = SamplingParams.create(temperature=0.8, forbid_eos=True)
    blen = frames + 32
    voc = jax.jit(lambda p, codes: vocoder_forward(cfg.vocoder, p, codes))

    def decode_ms(c, p, B, max_len, n, fast_forward=None):
        """Decode-only ms per frame over n chunks (compiled first)."""
        fns = make_generate_fns(c, batch=B, max_len=max_len, chunk_len=chunk)
        st, bd = fns.prefill(p, ids[:1].repeat(B, 0), lens[:1].repeat(B, 0), key)
        if fast_forward is not None:
            st = fast_forward(st)
        step = lambda s: fns.decode(p, s, bd.trailing, bd.trailing_len,  # noqa: E731
                                    bd.tts_pad_embed, sp)
        st, _ = timed(lambda s: step(s)[0], st)  # compile
        t0 = time.perf_counter()
        for _ in range(n):
            st = step(st)[0]
        jax.block_until_ready(st)
        return (time.perf_counter() - t0) / (n * chunk) * 1e3

    # --- headline: prefill + decode + chunked vocode, one request -----------
    fns = make_generate_fns(cfg, batch=batch, max_len=blen, chunk_len=chunk)

    def request():
        st, bd = fns.prefill(params, ids, lens, key)
        audios = []
        for _ in range(n_chunks):
            st, fr, _ = fns.decode(params, st, bd.trailing, bd.trailing_len,
                                   bd.tts_pad_embed, sp)
            audios.append(voc(params["vocoder"], fr))
        return audios

    _, compile_s = timed(request)
    log(f"headline compile+run: {compile_s:.1f}s")
    (_, _), prefill_s = timed(fns.prefill, params, ids, lens, key)
    _, total_s = timed(request)
    audio_s = frames / FRAME_RATE * batch
    rtf = audio_s / total_s
    frame_ms = total_s / frames * 1e3  # incl. amortized prefill and vocoder

    # --- TTFA: prefill + a small first chunk + its vocode ------------------
    fns_s = make_generate_fns(cfg, batch=batch, max_len=blen, chunk_len=ttfa_chunk)

    def first_audio():
        st, bd = fns_s.prefill(params, ids, lens, key)
        _, fr, _ = fns_s.decode(params, st, bd.trailing, bd.trailing_len,
                                bd.tts_pad_embed, sp)
        return voc(params["vocoder"], fr)

    timed(first_audio)  # compile
    _, ttfa_s = timed(first_audio)

    result = {
        "metric": f"rtf_{model}_1gpu",
        "value": round(rtf, 3),
        "unit": "x_realtime",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "nvidia_smi": card,
        "model": model,
        "quant": quant,
        "kv_quant": "int8" if kv_quant else "none",
        "batch": batch,
        "frames": frames,
        "bucket_max_len": blen,
        "init_s": round(init_s, 1),
        "prefill_ms": round(prefill_s * 1e3, 2),
        "frame_ms": round(frame_ms, 3),
        "ttfa_ms": round(ttfa_s * 1e3, 2),
        "frames_per_s": round(frames * batch / total_s, 1),
    }
    if batch != 1:
        print(json.dumps(result), flush=True)
        return

    n_arm = max(2, n_chunks // 2)
    arms = [("decode_ms_per_frame", lambda: decode_ms(cfg, params, 1, blen, n_arm))]
    if not skip("SERVING"):
        for B in (8, 32):
            arms.append((f"serving_rtf_batch{B}", lambda B=B: (
                1e3 * B / FRAME_RATE / decode_ms(cfg, params, B, blen, n_arm))))
    if quant == "int8" and not skip("BF16"):
        arms.append(("bf16_decode_ms_per_frame",
                     lambda: decode_ms(cfg, bf16_params, 1, blen, n_arm)))
    if not skip("LONGFORM"):
        def to_end(st, fill=2000):
            # the expensive end of a 2048-frame request: attention spans it all
            return st._replace(
                pos=jnp.full_like(st.pos, fill),
                cache=st.cache._replace(length=jnp.full_like(st.cache.length, fill)),
                valid_mask=jnp.ones_like(st.valid_mask),
            )
        arms.append(("longform_decode_ms_per_frame",
                     lambda: decode_ms(cfg, params, 1, 2048 + 32, 2, to_end)))
    if not skip("KVQ"):
        other = cfg_f32kv if kv_quant else with_kvq(cfg)
        name = "decode_f32kv_ms_per_frame" if kv_quant else "decode_kvq_ms_per_frame"
        arms.append((name, lambda: decode_ms(other, params, 1, blen, n_arm)))
    for name, fn in arms:
        result[name] = round(fn(), 3)
        log(f"{name}: {result[name]}")

    # --- speculative decoding bounds (B=1): an always-wrong draft commits one
    # frame per verify (floor); force_accept commits K (ceiling) ------------
    if not skip("SPEC"):
        K, ITERS = 4, 8
        greedy = SamplingParams.create(temperature=0.0, forbid_eos=True)
        n_disp = max(2, frames // (K * ITERS))
        spec_len = max(frames, n_disp * K * ITERS) + 32

        def wrong_draft(state, k):
            return jnp.broadcast_to((state.pending[:, None, :] + 1) % 2048, (1, k - 1, 16)), None

        for name, draft, force in (("spec_floor", wrong_draft, False),
                                   ("spec_ceil", None, True)):
            kw = {"draft_fn": draft} if draft else {}
            sf = make_spec_generate_fns(cfg, max_len=spec_len, k=K, num_iters=ITERS,
                                        force_accept=force, **kw)
            st, bd, _, _ = sf.prefill(params, ids, lens, key, greedy)
            step = lambda s: sf.decode(params, s, bd.trailing, bd.trailing_len,  # noqa: E731
                                       bd.tts_pad_embed, greedy)
            timed(step, st)  # compile
            st, bd, _, _ = sf.prefill(params, ids, lens, key, greedy)
            valids = []
            t0 = time.perf_counter()
            for _ in range(n_disp):
                st, _, vd = step(st)
                valids.append(vd)
            jax.block_until_ready(valids)
            wall = time.perf_counter() - t0
            committed = int(sum(np.asarray(v).sum() for v in valids))
            result[f"{name}_ms_per_frame"] = round(wall / max(committed, 1) * 1e3, 3)
            result[f"{name}_accept"] = round(committed / (n_disp * ITERS * K), 3)
            log(f"{name}: {result[f'{name}_ms_per_frame']} ms/frame "
                f"(accept {result[f'{name}_accept']})")

    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
