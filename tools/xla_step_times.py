"""Time what XLA makes of the decode path on one GPU, and count its kernels.

    python -m tools.xla_step_times [--out chiprun_out/xla_step_times.json]

For 0.6B and 1.7B at their published widths, bf16 weights in the engine's
layout, batch 1 and 8, a 512-slot KV cache: the talker decode step, the
speculative S=K verify pass (K=4 tokens per talker forward, lm_head
included), the 15-step MTP chain (sampling included) and a whole frame
(code0 sample, MTP chain, text drip, talker step).  Each program runs STEPS steps in one
dispatch.  ms per step is the median wall time of REPEATS dispatches over
STEPS, after compiling; kernels per step and device-busy ms per step come
from a jax.profiler trace of one more dispatch (GPU stream events only).
These are the bar a hand-written kernel has to beat end to end.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

STEPS = 32
VERIFY_K = 4
REPEATS = 5
BUCKET = 512  # slots; filled to half, so 32 verify passes of 4 fit


def _stream_events(trace_dir: str):
    """(count, busy_ns, {kernel name: total ns}, {line: events}) of the GPU
    stream events."""
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    spans, names, lines = [], {}, {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines[f"{plane.name} {line.name}"] = len(events)
            if not line.name.startswith("Stream"):
                continue
            for ev in events:
                spans.append((ev.start_ns, ev.end_ns))
                names[ev.name] = names.get(ev.name, 0) + ev.duration_ns
    busy, end = 0, -1
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return len(spans), busy, names, lines


def measure(name: str, fn, args, log):
    jax.block_until_ready(fn(*args))  # compile
    walls = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            jax.block_until_ready(fn(*args))
        n, busy, kernels, lines = _stream_events(d)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    out = {
        "ms_per_step": float(np.median(walls)) / STEPS * 1e3,
        "kernels_per_step": n / STEPS,
        "device_busy_ms_per_step": busy / STEPS / 1e6,
        "top_kernels_ms_per_step": {k: v / STEPS / 1e6 for k, v in top},
        "trace_lines": lines,
    }
    log(f"{name}: {out['ms_per_step']:.3f} ms/step, "
        f"{out['kernels_per_step']:.1f} kernels/step, "
        f"busy {out['device_busy_ms_per_step']:.3f} ms/step")
    return out


def programs(cfg, params, batch: int):
    from leaxer_qwen3_tts_tpu.models.code_predictor import mtp_chain
    from leaxer_qwen3_tts_tpu.models.layers import transformer_forward
    from leaxer_qwen3_tts_tpu.ops.quant import dense
    from leaxer_qwen3_tts_tpu.models.talker import talker_decode_step, talker_init_cache
    from leaxer_qwen3_tts_tpu.runtime.generate import make_generate_fns
    from leaxer_qwen3_tts_tpu.runtime.sampling import SamplingParams, sample_token

    H = cfg.talker.hidden_size
    dt = cfg.talker.transformer.jnp_dtype
    sp = SamplingParams.create(temperature=0.8, forbid_eos=True)
    x = jnp.full((batch, H), 0.01, dt)
    fill = BUCKET // 2
    cache = talker_init_cache(cfg.talker, batch, BUCKET)
    cache = cache._replace(length=jnp.full((batch,), fill, jnp.int32))
    valid = jnp.arange(BUCKET)[None].repeat(batch, 0) < fill

    @jax.jit
    def talker(p, cache, valid):
        def body(c, i):
            cache, valid = c
            _, _, cache, valid = talker_decode_step(
                cfg.talker, p, x, jnp.full((batch,), fill, jnp.int32) + i, cache, valid)
            return (cache, valid), None
        return jax.lax.scan(body, (cache, valid), jnp.arange(STEPS))[0][0].k

    @jax.jit
    def verify(p, cache, valid):
        xk = jnp.broadcast_to(x[:, None], (batch, VERIFY_K, H))

        def body(c, i):
            cache, valid = c
            pos = fill + i * VERIFY_K + jnp.arange(VERIFY_K, dtype=jnp.int32)
            h, cache, valid = transformer_forward(
                cfg.talker.transformer, p["transformer"], xk,
                jnp.broadcast_to(pos, (batch, VERIFY_K)), cache, valid)
            return (cache, valid), dense(h, p["lm_head"])[:, 0, 0]
        return jax.lax.scan(body, (cache, valid), jnp.arange(STEPS))[1]

    @jax.jit
    def mtp(p, emb, key):
        def body(key, _):
            key, k = jax.random.split(key)
            subs, s, _ = mtp_chain(cfg.code_predictor, p, emb["pred_embed"], x, x, k,
                                   lambda kk, lg: sample_token(kk, lg, sp))
            return key, (subs, s)
        return jax.lax.scan(body, key, None, length=STEPS)[1]

    fns = make_generate_fns(cfg, batch=batch, max_len=BUCKET, chunk_len=STEPS, donate=False)
    ids = jnp.full((batch, 16), 100, jnp.int32)
    state, bundle = fns.prefill(params, ids, jnp.full((batch,), 16, jnp.int32),
                                jax.random.PRNGKey(1))

    def frame(p, state):
        return fns.decode(p, state, bundle.trailing, bundle.trailing_len,
                          bundle.tts_pad_embed, sp)[1]

    return {
        "talker_step": (talker, (params["talker"], cache, valid)),
        "verify_k4": (verify, (params["talker"], cache, valid)),
        "mtp_chain": (mtp, (params["code_predictor"], params["embeddings"],
                            jax.random.PRNGKey(2))),
        "frame": (frame, (params, state)),
    }


def main(argv=None) -> int:
    from leaxer_qwen3_tts_tpu.config import QWEN3_TTS_06B, QWEN3_TTS_17B
    from leaxer_qwen3_tts_tpu.ops.quant import fuse_params
    from leaxer_qwen3_tts_tpu.runtime.weights import init_params
    from leaxer_qwen3_tts_tpu.utils.compile_cache import enable_compile_cache
    from leaxer_qwen3_tts_tpu.utils.gpu import nvidia_smi, require_gpu

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/xla_step_times.json")
    args = ap.parse_args(argv)
    require_gpu(jax.devices(), who="xla_step_times")
    dev = jax.devices()[0]
    card = nvidia_smi().splitlines()[0]
    print(f"{dev.device_kind}; nvidia-smi: {card}; jax {jax.__version__}", flush=True)
    enable_compile_cache()
    result = {"device_kind": dev.device_kind, "nvidia_smi": card, "steps": STEPS,
              "bucket": BUCKET, "dtype": "bfloat16", "runs": {}}
    for label, cfg in (("0.6b", QWEN3_TTS_06B), ("1.7b", QWEN3_TTS_17B)):
        # op by op: a jitted init compiles one random kernel per leaf
        params = fuse_params(init_params(cfg, jax.random.PRNGKey(0), with_speaker_encoder=False))
        for batch in (1, 8):
            for name, (fn, fargs) in programs(cfg, params, batch).items():
                key = f"{label}/B{batch}/{name}"
                result["runs"][key] = measure(key, fn, fargs, lambda m: print(m, flush=True))
        del params
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
