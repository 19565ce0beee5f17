"""int8-vs-bf16 fidelity report for the quantized decode configuration.

The fast configuration is int8 weight-only; the quality-exact configuration
is bf16.  This tool quantifies what
int8 changes, using the same per-stage oracles as the parity gate
(tools/parity_check.compute_stages) on the SAME weights:

  * prefill / per-step decode logit correlation and L-inf
  * greedy code agreement (exact-match fraction + first divergence step)
  * waveform L-inf / RMS over the agreeing prefix (after the first code
    divergence the audio legitimately differs, so global waveform distance
    is not meaningful)

Caveat: on random-init weights the logits are near-uniform, so greedy top-1
agreement is a PESSIMISTIC bound — real checkpoints have peaked logits and
agree for longer.  Rerun on converted real weights for the fidelity numbers
that matter (docs/INT8_QUALITY.md records both).

Usage:
  python -m tools.quality_report --model <ckpt> [--text ...] [--max-frames N]
Prints one JSON line; exit 0 always (reporting, not a gate).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def compare(bf16_stages: dict, int8_stages: dict) -> dict:
    out: dict = {}
    a, b = bf16_stages, int8_stages

    def corr(x, y):
        x, y = np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel()
        if x.size == 0 or x.std() == 0 or y.std() == 0:
            return 1.0
        return float(np.corrcoef(x, y)[0, 1])

    out["prefill_logit_corr"] = corr(a["prefill_logits"], b["prefill_logits"])
    out["prefill_logit_linf"] = float(
        np.max(np.abs(a["prefill_logits"] - b["prefill_logits"]))
    )

    ca, cb = a["codes"], b["codes"]
    n = min(len(ca), len(cb))
    if n:
        eq = (ca[:n] == cb[:n]).all(axis=1)
        first_div = int(np.argmin(eq)) if not eq.all() else n
        out["frames_compared"] = n
        out["code_agreement"] = float((ca[:n] == cb[:n]).mean())
        out["first_divergence_frame"] = first_div
        # per-step logit fidelity over the AGREEING prefix (identical history)
        la, lb = a["decode_logits"], b["decode_logits"]
        m = min(len(la), len(lb), max(first_div, 1))
        out["decode_logit_corr_agreeing"] = corr(la[:m], lb[:m])
        out["decode_logit_linf_agreeing"] = float(
            np.max(np.abs(la[:m] - lb[:m]))
        ) if m else 0.0
        # waveform distance over the agreeing prefix
        spf = 2000
        wa = a["waveform"][: first_div * spf]
        wb = b["waveform"][: first_div * spf]
        k = min(len(wa), len(wb))
        if k:
            out["waveform_linf_agreeing"] = float(np.max(np.abs(wa[:k] - wb[:k])))
            out["waveform_rms_agreeing"] = float(
                np.sqrt(np.mean((wa[:k] - wb[:k]) ** 2))
            )
    return out


def _random_engine_inputs(preset: str):
    """Device-filled random params for a preset (no host->device weight
    transfer — the pattern bench.py uses; values are irrelevant to the
    numeric-fidelity comparison, which runs both configs on the SAME params)."""
    import jax
    import jax.numpy as jnp

    from leaxer_qwen3_tts_tpu.config import PRESETS
    from leaxer_qwen3_tts_tpu.runtime.weights import init_params

    cfg = PRESETS[preset]
    shapes = jax.eval_shape(
        lambda k: init_params(cfg, k, with_speaker_encoder=False),
        jax.random.PRNGKey(0),
    )

    def fill():
        leaves, treedef = jax.tree_util.tree_flatten(shapes)
        out = []
        for i, sd in enumerate(leaves):
            n = 1
            for dd in sd.shape:
                n *= dd
            v = (jnp.arange(n, dtype=jnp.float32) * 16807.0 + i * 131.0) % 199.0
            out.append(((v / 199.0 - 0.5) * 0.04).reshape(sd.shape).astype(sd.dtype))
        return jax.tree_util.tree_unflatten(treedef, out)

    return cfg, jax.jit(fill)()


def _tiny_tokenizer():
    """Byte-level fallback tokenizer (256-proxy vocab) for --random-preset:
    the fidelity comparison only needs SOME deterministic ids."""
    import json
    import tempfile

    from leaxer_qwen3_tts_tpu.frontend import Tokenizer
    from leaxer_qwen3_tts_tpu.frontend._bpe_py import byte_to_proxy

    proxy = byte_to_proxy()
    vocab = {proxy[b]: b for b in range(256)}
    d = tempfile.mkdtemp()
    with open(f"{d}/vocab.json", "w") as f:
        json.dump(vocab, f, ensure_ascii=True)
    with open(f"{d}/merges.txt", "w") as f:
        f.write("#version: 0.2\n")
    return Tokenizer(f"{d}/vocab.json", f"{d}/merges.txt")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools.quality_report", description=__doc__)
    p.add_argument("--model", help="framework checkpoint dir")
    p.add_argument("--random-preset", help="preset name: random-init params "
                   "filled on device (no checkpoint needed)")
    p.add_argument("--text", default="hello world")
    p.add_argument("--language", default="auto")
    p.add_argument("--max-frames", type=int, default=48)
    p.add_argument("--quantize", default="int8", choices=["int8", "int4"],
                   help="quantized configuration to compare against bf16")
    p.add_argument("--kv-quant", action="store_true",
                   help="compare the int8 KV CACHE against the bf16 cache "
                        "with UNquantized weights (isolates cache fidelity "
                        "from weight quantization)")
    args = p.parse_args(argv)
    if not args.model and not args.random_preset:
        p.error("need --model or --random-preset")

    from leaxer_qwen3_tts_tpu.api.engine import TTSEngine

    from .parity_check import compute_stages

    if args.random_preset:
        cfg, params = _random_engine_inputs(args.random_preset)
        tok = _tiny_tokenizer()

    if args.kv_quant:
        # isolate the CACHE: both engines keep full-precision weights
        variants = (("cache_bf16", dict()), ("cache_int8", dict(kv_quant=True)))
        base, other = "cache_bf16", "cache_int8"
    else:
        variants = (("bf16", dict()), (args.quantize, dict(quantize=args.quantize)))
        base, other = "bf16", args.quantize
    results = {}
    for name, kw in variants:
        if args.random_preset:
            eng = TTSEngine(config=cfg, params=params, tokenizer=tok, **kw)
        else:
            eng = TTSEngine(args.model, **kw)
        if not eng.is_ready():
            print(f"engine ({name}) not ready: {eng.get_error()}", file=sys.stderr)
            return 1
        results[name] = compute_stages(
            eng, args.text, args.language, args.max_frames
        )
        del eng

    report = compare(results[base], results[other])
    report["text"] = args.text
    report["max_frames"] = args.max_frames
    report["quantize"] = "kv_int8" if args.kv_quant else args.quantize
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
