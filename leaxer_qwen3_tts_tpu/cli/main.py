"""CLI: flag-for-flag parity with the reference (main_onnx.cpp:60-192), plus
framework extensions (--seed for determinism, --speaker presets,
--stream to write audio incrementally, --verbose metrics).

Behavioral parity points: default output `output.wav`; unknown --lang falls
back to auto (parse_language, main_onnx.cpp:79-86); output parent dirs are
created; the summary prints "Generated X.XX seconds of audio"; exit code 1 on
missing/invalid inputs or failed synthesis; output WAV is 16-bit PCM mono
24 kHz without peak normalization (the reference CLI's local write_wav,
main_onnx.cpp:15-58).
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="leaxer-qwen3-tts-tpu",
        description="Qwen3-TTS inference (JAX/XLA)",
    )
    p.add_argument("-m", "--model", help="model checkpoint directory (required)")
    p.add_argument("-p", "--prompt", help="text to synthesize (required)")
    p.add_argument("-o", "--output", default="output.wav", help="output WAV file")
    p.add_argument("--lang", default="auto", help="language: auto, en, zh, ja, ko")
    p.add_argument("--ref", help="reference audio for voice clone (3s WAV)")
    p.add_argument("--temp", type=float, default=0.8, help="temperature (0 = greedy)")
    p.add_argument("--top-k", type=int, default=50, help="top-k sampling")
    p.add_argument("--top-p", type=float, default=0.95, help="top-p sampling")
    p.add_argument("--max-tokens", type=int, default=2048, help="max frames to generate")
    p.add_argument("--seed", type=int, default=0, help="sampling PRNG seed (deterministic)")
    p.add_argument("--speaker", help="preset speaker name (CustomVoice models)")
    p.add_argument(
        "--instruct",
        help="EXPERIMENTAL: voice-design instruction text (VoiceDesign "
             "models). The prompt layout is this repo's invention — the "
             "reference lists VoiceDesign as planned (README.md:118-126) "
             "and no checkpoint exists to validate against",
    )
    p.add_argument(
        "--quantize", choices=["int8", "int4"],
        help="weight-only quantization for faster decode",
    )
    p.add_argument(
        "--kv-quant", action="store_true",
        help="int8 KV cache (per-slot scales): halves cache bandwidth for "
             "long-form and large-batch serving",
    )
    p.add_argument(
        "--spec-k", type=int, choices=range(2, 9), metavar="K",
        help="speculative frame decoding: verify K drafted frames per talker "
             "pass (greedy output identical to sequential decode)",
    )
    p.add_argument(
        "--stream", action="store_true",
        help="write audio to the output WAV incrementally as it decodes "
             "(header patched at the end; a tailing player hears audio "
             "before synthesis finishes)",
    )
    p.add_argument("--verbose", action="store_true", help="print per-stage metrics")
    return p


def parse_language(lang: str) -> str:
    """Unknown values fall back to auto (reference parse_language semantics)."""
    s = (lang or "auto").lower()
    if s in ("en", "english", "zh", "chinese", "ja", "japanese", "ko", "korean"):
        return s
    return "auto"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if not args.model or not args.prompt:
        print("Error: --model and --prompt are required", file=sys.stderr)
        build_parser().print_help(sys.stderr)
        return 1
    if not os.path.isdir(args.model):
        print(f"Error: model directory not found: {args.model}", file=sys.stderr)
        return 1

    lang = parse_language(args.lang)
    print(f"Model: {args.model}")
    print(f"Text: {args.prompt}")
    if args.ref:
        print(f"Reference: {args.ref}")
    print(f"Language: {lang}")
    print(f"Output: {args.output}\n")

    parent = os.path.dirname(args.output)
    if parent:
        os.makedirs(parent, exist_ok=True)

    # import late so --help stays fast (no jax import)
    from ..api.engine import TTSEngine
    from ..config import SAMPLE_RATE
    from ..frontend import write_wav
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    engine = TTSEngine(args.model, max_frames=args.max_tokens, quantize=args.quantize,
                       spec_k=args.spec_k, kv_quant=args.kv_quant)
    if not engine.is_ready():
        print(f"Error: {engine.get_error()}", file=sys.stderr)
        return 1

    sampling = dict(
        language=lang,
        temperature=args.temp,
        top_k=args.top_k,
        top_p=args.top_p,
        max_tokens=args.max_tokens,
        seed=args.seed,
    )
    if args.instruct:
        sampling["instruct"] = args.instruct

    print("Synthesizing...")
    try:
        if args.stream and not args.ref and not args.speaker:
            # incremental write: audio chunks land in the file as they
            # decode (streaming synthesis — a capability the reference
            # lacks; it vocodes once at the end, main_onnx.cpp)
            from ..frontend import StreamingWavWriter

            result = None
            with StreamingWavWriter(args.output, SAMPLE_RATE) as w:
                for item in engine.synthesize_stream(args.prompt, **sampling):
                    if hasattr(item, "metrics"):
                        result = item
                    else:
                        w.write(item)
        else:
            if args.stream:
                print("(--stream with --ref/--speaker: falling back to "
                      "one-shot write)", file=sys.stderr)
            if args.ref:
                if not engine.has_speaker_encoder():
                    print(
                        "Error: speaker encoder not available for voice clone",
                        file=sys.stderr,
                    )
                    return 1
                result = engine.synthesize_clone(args.prompt, args.ref, **sampling)
            elif args.speaker:
                result = engine.synthesize_speaker(args.prompt, args.speaker, **sampling)
            else:
                result = engine.synthesize(args.prompt, **sampling)
    except Exception as e:
        print(f"Error: synthesis failed: {e}", file=sys.stderr)
        return 1

    if result is None or result.audio.size == 0:
        print("Error: synthesis failed", file=sys.stderr)
        return 1

    print(f"Generated {result.audio.size / SAMPLE_RATE:.2f} seconds of audio")
    if args.verbose:
        print(result.metrics.summary())

    if not (args.stream and not args.ref and not args.speaker):
        try:
            write_wav(args.output, result.audio, SAMPLE_RATE)
        except Exception as e:
            print(f"Error: failed to write WAV: {e}", file=sys.stderr)
            return 1
    print(f"Saved to: {args.output}")
    return 0
