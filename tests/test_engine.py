"""Engine + CLI integration tests on the tiny model (full pipeline:
text -> tokenize -> prefill -> chunked decode -> streaming vocoder -> WAV)."""

import os
import shutil

import numpy as np
import pytest

from leaxer_qwen3_tts_tpu.api.engine import EngineError, TTSEngine
from leaxer_qwen3_tts_tpu.config import SAMPLE_RATE
from leaxer_qwen3_tts_tpu.frontend import Tokenizer, read_wav, write_wav
from leaxer_qwen3_tts_tpu.runtime.prompt import wrap_text_ids

MAX_FRAMES = 8
CHUNK = 4


@pytest.fixture(scope="module")
def engine(tiny_model, tiny_vocab_files):
    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    eng = TTSEngine(
        config=cfg,
        params=params,
        tokenizer=Tokenizer(vocab_path, merges_path),
        max_frames=MAX_FRAMES,
        chunk_len=CHUNK,
    )
    assert eng.is_ready(), eng.get_error()
    return eng


SPF = 2000  # tiny vocoder upsample_rates (10,8,5,5) -> 2000 samples/frame


def test_synthesize_end_to_end(engine):
    r = engine.synthesize("hello world", temperature=0.0)
    assert r.audio.dtype == np.float32
    assert r.audio.size == r.codes.shape[0] * SPF
    assert r.codes.shape[1] == 16
    assert r.codes.shape[0] <= MAX_FRAMES
    assert np.isfinite(r.audio).all()
    assert (r.codes[:, 0] < 2048).all()  # suppression: no control tokens
    m = r.metrics
    assert m.total_seconds > 0
    assert set(m.stage_seconds) >= {"tokenize", "prefill", "decode", "vocode"}
    assert m.ttfa_seconds is not None and m.ttfa_seconds <= m.total_seconds


def test_max_tokens_respected(engine):
    # regression: max_tokens below / not a multiple of chunk_len must bound the
    # result (the decode loop runs whole chunks; outputs are trimmed)
    r = engine.synthesize("hello world", temperature=0.0, max_tokens=3)
    assert r.codes.shape[0] <= 3
    assert r.audio.size == r.codes.shape[0] * SPF


def test_seeded_determinism(engine):
    a = engine.synthesize("hello world", seed=7, temperature=0.9)
    b = engine.synthesize("hello world", seed=7, temperature=0.9)
    np.testing.assert_array_equal(a.audio, b.audio)
    np.testing.assert_array_equal(a.codes, b.codes)
    c = engine.synthesize("hello world", seed=8, temperature=0.9)
    assert a.codes.shape != c.codes.shape or not np.array_equal(a.codes, c.codes)


def test_stream_matches_offline(engine):
    chunks = []
    result = None
    for item in engine.synthesize_stream("hello world", temperature=0.0):
        if hasattr(item, "metrics"):
            result = item
        else:
            chunks.append(item)
    full = np.concatenate(chunks)
    assert len(chunks) >= 1
    # the offline waveform is the valid prefix of the streamed audio
    np.testing.assert_array_equal(full[: result.audio.size], result.audio)
    # streamed samples past EOS are zeroed
    assert np.all(full[result.audio.size :] == 0.0)


def test_batch_matches_single_greedy(engine):
    single = engine.synthesize("hello world", temperature=0.0)
    batch = engine.synthesize_batch(["hello world", "hello"], temperature=0.0)
    assert len(batch) == 2
    np.testing.assert_array_equal(batch[0].codes, single.codes)
    np.testing.assert_allclose(batch[0].audio, single.audio, atol=2e-4)


def test_synthesize_tokens_matches_text(engine):
    ids = engine.tokenizer.encode("hello world")
    wrapped = wrap_text_ids(ids)
    a = engine.synthesize_tokens(wrapped, temperature=0.0)
    b = engine.synthesize("hello world", temperature=0.0)
    np.testing.assert_array_equal(a.codes, b.codes)


def test_language_control(engine):
    """Explicit language changes the codec prefill (THINK + lang id vs
    NOTHINK; reference tts_onnx.cpp:466-477) and with it the output."""
    auto = engine.synthesize("hello world", language="auto", temperature=0.0)
    results = {}
    for lang in ("en", "zh", "ja", "ko"):
        r = engine.synthesize("hello world", language=lang, temperature=0.0)
        assert r.codes.shape[1] == 16
        results[lang] = r
    # language token conditions generation: en differs from auto
    en = results["en"]
    assert (en.codes.shape != auto.codes.shape) or not np.array_equal(
        en.codes, auto.codes
    )
    # full names are accepted like the reference parse_language
    full = engine.synthesize("hello world", language="english", temperature=0.0)
    np.testing.assert_array_equal(full.codes, en.codes)


def test_instruct_conditioning(engine):
    """--instruct (VoiceDesign-style, 'planned' in the reference roadmap):
    the instruction segment conditions generation; same instruct is
    deterministic."""
    plain = engine.synthesize("hello world", temperature=0.0)
    a = engine.synthesize("hello world", temperature=0.0, instruct="hello")
    b = engine.synthesize("hello world", temperature=0.0, instruct="hello")
    np.testing.assert_array_equal(a.codes, b.codes)
    assert (a.codes.shape != plain.codes.shape) or not np.array_equal(
        a.codes, plain.codes
    )
    c = engine.synthesize("hello world", temperature=0.0, instruct="world hello")
    assert (a.codes.shape != c.codes.shape) or not np.array_equal(a.codes, c.codes)


def test_unknown_language_rejected(engine):
    from leaxer_qwen3_tts_tpu.api.engine import EngineError

    with pytest.raises((EngineError, ValueError)):
        engine.synthesize("hello", language="klingon")


def test_clone_path(engine, tmp_path):
    sr = 16000
    t = np.arange(sr * 1) / sr
    ref = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    ref_path = str(tmp_path / "ref.wav")
    write_wav(ref_path, ref, sr)

    assert engine.has_speaker_encoder()
    emb = engine.extract_speaker_embedding(ref_path)
    assert emb.shape == (64,)  # tiny model: output_dim == talker hidden
    assert np.isfinite(emb).all()

    r = engine.synthesize_clone("hello", ref_path, temperature=0.0)
    assert r.audio.size > 0
    # conditioning changes the output vs the plain path
    plain = engine.synthesize("hello", temperature=0.0)
    assert (r.codes.shape != plain.codes.shape) or not np.array_equal(
        r.codes, plain.codes
    )


def test_clone_plus_instruct(engine, tmp_path):
    """Voice clone and voice instruction compose (both condition the prompt)."""
    sr = 16000
    t = np.arange(sr) / sr
    ref_path = str(tmp_path / "ref2.wav")
    write_wav(ref_path, (0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32), sr)
    a = engine.synthesize_clone("hello", ref_path, temperature=0.0)
    b = engine.synthesize_clone("hello", ref_path, temperature=0.0, instruct="world")
    assert (a.codes.shape != b.codes.shape) or not np.array_equal(a.codes, b.codes)


def test_speaker_fallback_without_table(engine):
    r = engine.synthesize_speaker("hello", "serena", temperature=0.0)
    plain = engine.synthesize("hello", temperature=0.0)
    np.testing.assert_array_equal(r.codes, plain.codes)  # reference stub parity


def test_speaker_with_table(tiny_model, tiny_vocab_files):
    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    params2 = dict(params)
    rng = np.random.default_rng(0)
    params2["speaker_table"] = rng.standard_normal((9, 64)).astype(np.float32)
    eng = TTSEngine(
        config=cfg,
        params=params2,
        tokenizer=Tokenizer(vocab_path, merges_path),
        max_frames=MAX_FRAMES,
        chunk_len=CHUNK,
    )
    r = eng.synthesize_speaker("hello", "serena", temperature=0.0)
    assert r.audio.size >= 0
    with pytest.raises(EngineError):
        eng.synthesize_speaker("hello", "not-a-speaker")


def test_first_chunk_ramp(tiny_model, tiny_vocab_files):
    """TTFA ramp: a small first decode chunk streams audio earlier and is
    bit-identical to uniform chunking (the early vocoder context is the
    complete history, so no seams)."""
    from leaxer_qwen3_tts_tpu.frontend import Tokenizer

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    tok = Tokenizer(vocab_path, merges_path)
    common = dict(config=cfg, params=params, tokenizer=tok, max_frames=8)
    ramped = TTSEngine(**common, chunk_len=4, first_chunk_len=2)
    uniform = TTSEngine(**common, chunk_len=4, first_chunk_len=4)

    chunks = []
    result = None
    for item in ramped.synthesize_stream("hello world", temperature=0.0):
        if hasattr(item, "metrics"):
            result = item
        else:
            chunks.append(item)
    assert chunks[0].size == 2 * SPF  # small first chunk
    assert all(c.size <= 4 * SPF for c in chunks[1:])
    # streamed audio is capped at max_frames: the last chunk is trimmed
    # instead of overshooting (consumers never hear frames the final
    # result would drop)
    assert sum(c.size for c in chunks) == 8 * SPF

    r_uniform = uniform.synthesize("hello world", temperature=0.0)
    np.testing.assert_array_equal(result.codes, r_uniform.codes)
    np.testing.assert_allclose(result.audio, r_uniform.audio, atol=2e-5)


def test_kv_bucket_ladder_matches_single_bucket(tiny_model, tiny_vocab_files):
    """Greedy output is identical whether the cache grows through buckets or
    starts at full size (pad slots are invalid until written)."""
    from leaxer_qwen3_tts_tpu.frontend import Tokenizer

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    tok = Tokenizer(vocab_path, merges_path)
    common = dict(config=cfg, params=params, tokenizer=tok,
                  max_frames=12, chunk_len=4)
    laddered = TTSEngine(**common, kv_buckets=(20, 28))
    single = TTSEngine(**common, kv_buckets=())
    assert len(laddered.kv_ladder) == 3  # 20, 28, 44
    assert single.kv_ladder == (44,)
    a = laddered.synthesize("hello world", temperature=0.0)
    b = single.synthesize("hello world", temperature=0.0)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_allclose(a.audio, b.audio, atol=2e-5)


def test_engine_not_ready_contract(tmp_path):
    eng = TTSEngine(str(tmp_path / "missing"))
    assert not eng.is_ready()
    assert eng.get_error()
    with pytest.raises(EngineError):
        eng.synthesize("hello")


def test_checkpoint_roundtrip_and_cli(tiny_model, tiny_vocab_files, tmp_path):
    from leaxer_qwen3_tts_tpu.cli.main import main
    from leaxer_qwen3_tts_tpu.runtime.weights import save_checkpoint

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    model_dir = str(tmp_path / "ckpt")
    save_checkpoint(model_dir, cfg, params)
    shutil.copy(vocab_path, os.path.join(model_dir, "vocab.json"))
    shutil.copy(merges_path, os.path.join(model_dir, "merges.txt"))

    out = str(tmp_path / "out" / "hello.wav")
    rc = main(
        ["-m", model_dir, "-p", "hello world", "-o", out,
         "--temp", "0", "--max-tokens", str(MAX_FRAMES)]
    )
    assert rc == 0
    audio, sr = read_wav(out)
    assert sr == SAMPLE_RATE
    assert audio.size > 0


def test_cli_errors(tmp_path):
    from leaxer_qwen3_tts_tpu.cli.main import main

    assert main(["-p", "hi"]) == 1  # missing model
    assert main(["-m", str(tmp_path / "nope"), "-p", "hi"]) == 1  # bad dir


def test_safetensors_checkpoint_roundtrip(tiny_model, tmp_path):
    from leaxer_qwen3_tts_tpu.runtime.weights import (
        load_checkpoint,
        save_checkpoint,
    )
    import jax

    cfg, params = tiny_model
    d = str(tmp_path / "st_ckpt")
    save_checkpoint(d, cfg, params, fmt="safetensors")
    cfg2, params2 = load_checkpoint(d)
    assert cfg2.talker.transformer.hidden_size == cfg.talker.transformer.hidden_size
    a = jax.device_get(params["talker"]["lm_head"])
    b = jax.device_get(params2["talker"]["lm_head"])
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
def test_bf16_checkpoint_roundtrip(tiny_model, tmp_path, fmt):
    """A bfloat16 model saves and loads with its dtype and bits intact (npz
    stores bfloat16 as raw 2-byte void)."""
    import jax
    import jax.numpy as jnp

    from leaxer_qwen3_tts_tpu.runtime.weights import load_checkpoint, save_checkpoint

    cfg, params = tiny_model
    bf = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, params)
    d = str(tmp_path / f"bf16_{fmt}")
    save_checkpoint(d, cfg, bf, fmt=fmt)
    _, back = load_checkpoint(d)
    assert jax.tree.structure(back) == jax.tree.structure(bf)
    for a, b in zip(jax.tree.leaves(bf), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def test_batch_per_request_metrics(engine):
    """Each batched result carries its own frame/audio counts (round-1
    verdict: metrics.frames was the max over streams for every element)."""
    batch = engine.synthesize_batch(["hello world", "hello"], temperature=0.0)
    for r in batch:
        assert r.metrics.frames == r.codes.shape[0]
        assert r.metrics.audio_seconds == pytest.approx(
            r.codes.shape[0] * SPF / SAMPLE_RATE
        )
    # at least the stage timers are shared (one SPMD program)
    assert batch[0].metrics.total_seconds == batch[1].metrics.total_seconds


def test_token_id_validation(engine):
    """Out-of-range ids raise a typed error instead of gathering NaN audio
    (jnp.take fills NaN for out-of-range indices)."""
    with pytest.raises(EngineError, match="out of range"):
        engine.synthesize_tokens([10**9])
    with pytest.raises(EngineError, match="out of range"):
        engine.synthesize_tokens([-1, 5])


def test_kv_ladder_never_overruns(tiny_model, tiny_vocab_files):
    """A long prompt (big instruct bucket) + full frame budget must cap
    generation to what the top bucket holds, not run the ladder off its end
    (round-1 advisor finding: IndexError mid-synthesis)."""
    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    tok = Tokenizer(vocab_path, merges_path)
    eng = TTSEngine(
        config=cfg, params=params, tokenizer=tok,
        max_frames=12, chunk_len=4, text_bucket=4,
    )
    # i_bucket=24 -> P=32; top bucket = 12+32=44; budget = 44-32-4 = 8 < 12
    instruct = " ".join(["hello"] * 12)  # >= 21 tokens
    assert len(tok.encode(instruct)) >= 21
    r = eng.synthesize("hello world", temperature=0.0, instruct=instruct)
    assert r.codes.shape[0] <= 8  # capped to the bucket budget, no crash


def test_prompt_too_long_raises(tiny_model, tiny_vocab_files):
    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    tok = Tokenizer(vocab_path, merges_path)
    eng = TTSEngine(
        config=cfg, params=params, tokenizer=tok,
        max_frames=4, chunk_len=4, text_bucket=4,
    )
    # i_bucket >= 32 -> P >= 40 > top bucket 36
    with pytest.raises(EngineError, match="too long"):
        eng.synthesize(
            "hello", temperature=0.0, instruct=" ".join(["hello"] * 40)
        )


def test_cli_stream_writes_incremental_wav(tiny_model, tiny_vocab_files, tmp_path):
    """--stream writes a valid WAV incrementally whose PCM prefix matches the
    one-shot output (trailing post-EOS silence may pad the streamed file)."""
    import json
    import shutil as _sh

    from leaxer_qwen3_tts_tpu.cli.main import main as cli_main
    from leaxer_qwen3_tts_tpu.runtime.weights import save_checkpoint

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, cfg, params)
    _sh.copy(vocab_path, os.path.join(d, "vocab.json"))
    _sh.copy(merges_path, os.path.join(d, "merges.txt"))

    out1 = str(tmp_path / "oneshot.wav")
    out2 = str(tmp_path / "streamed.wav")
    args = ["-m", d, "-p", "hello world", "--temp", "0", "--max-tokens", "6",
            "--seed", "1"]
    assert cli_main(args + ["-o", out1]) == 0
    assert cli_main(args + ["-o", out2, "--stream"]) == 0

    a1, sr1 = read_wav(out1)
    a2, sr2 = read_wav(out2)
    assert sr1 == sr2 == SAMPLE_RATE
    n = min(a1.size, a2.size)
    assert n > 0
    np.testing.assert_allclose(np.asarray(a2)[:n], np.asarray(a1)[:n],
                               atol=1e-4)
    # any extra streamed tail is post-EOS silence
    assert np.abs(np.asarray(a2)[n:]).max(initial=0.0) == 0.0


def test_engine_warmup(tiny_model, tiny_vocab_files):
    """warmup() pre-compiles the request path (incl. ladder rungs) and a
    subsequent synthesize reuses the cached fns (no new cache entries)."""
    from leaxer_qwen3_tts_tpu.api.engine import TTSEngine
    from leaxer_qwen3_tts_tpu.frontend import Tokenizer

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    eng = TTSEngine(config=cfg, params=params,
                    tokenizer=Tokenizer(vocab_path, merges_path),
                    max_frames=24, chunk_len=4, first_chunk_len=2,
                    kv_buckets=(16, 32))
    assert eng.is_ready(), eng.get_error()
    dt = eng.warmup()
    assert dt > 0
    n_fns = len(eng._fns_cache)
    n_voc = len(eng._vocode_cache)
    r = eng.synthesize("hello world", temperature=0.0, max_tokens=24)
    assert r.metrics.frames > 0
    assert len(eng._fns_cache) == n_fns, "synthesize compiled NEW decode fns"
    assert len(eng._vocode_cache) == n_voc, "synthesize compiled NEW vocoders"
