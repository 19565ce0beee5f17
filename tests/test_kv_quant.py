"""int8 KV cache (per-slot scales) — XLA-path correctness.

The quantized cache stores post-RoPE K/V as int8 with per-(slot, head) f32
scales; dequant happens in the score/weight domain (ops/attention.py).  These
tests pin: quantization round-trip accuracy, forward-path closeness to the
bf16 cache, spec==sequential exactness UNDER quantization (both paths read
the same quantized values, so greedy equality must survive), engine e2e,
bucket growth, and the continuous pool.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from leaxer_qwen3_tts_tpu.models.layers import (
    KVCache,
    init_kv_cache,
    quantize_kv,
    splice_kv_cache,
    transformer_forward,
    init_transformer_params,
)


def _tiny_tr(quant: bool):
    import dataclasses

    from leaxer_qwen3_tts_tpu.config import TransformerConfig

    return TransformerConfig(
        hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=16, intermediate_size=128, dtype="float32",
        kv_cache_quant=quant,
    )


def test_quantize_kv_roundtrip():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(3, 5, 2, 16)).astype(np.float32) * 2.0)
    q, s = quantize_kv(x)
    assert q.dtype == jnp.int8 and s.shape == (3, 5, 2)
    deq = np.asarray(q, np.float32) * np.asarray(s)[..., None]
    err = np.abs(deq - np.asarray(x)).max(axis=-1)
    amax = np.abs(np.asarray(x)).max(axis=-1)
    assert (err <= amax / 127.0 * 0.51 + 1e-7).all()  # half-ulp of the grid


def test_quantize_kv_zero_vector():
    q, s = quantize_kv(jnp.zeros((1, 1, 1, 16)))
    assert np.asarray(q).max() == 0 and np.isfinite(np.asarray(s)).all()


def test_forward_quantized_close_to_exact():
    """Hidden states with the int8 cache stay close to the bf16/f32 cache's
    (error bounded by the int8 grid, amplified ~L layers)."""
    cfg_q, cfg_f = _tiny_tr(True), _tiny_tr(False)
    params = init_transformer_params(cfg_f, jax.random.PRNGKey(0))
    B, S, T = 2, 6, 16
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(B, S, 64)).astype(np.float32) * 0.3)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    def run(cfg):
        cache = init_kv_cache(cfg, B, T)
        valid = jnp.zeros((B, T), bool)
        h, cache, valid = transformer_forward(cfg, params, x, pos, cache, valid)
        return np.asarray(h), cache

    h_f, _ = run(cfg_f)
    h_q, cache_q = run(cfg_q)
    assert cache_q.k.dtype == jnp.int8
    assert cache_q.k_scale.shape == (2, B, 2, T)
    denom = np.abs(h_f).max()
    assert np.abs(h_q - h_f).max() / denom < 0.05


def test_quantized_decode_steps_match_prefill():
    """Writing one token at a time into the quantized cache == one S-token
    prefill (slot-wise quantization is write-order independent)."""
    cfg = _tiny_tr(True)
    params = init_transformer_params(cfg, jax.random.PRNGKey(2))
    B, S, T = 1, 5, 8
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(B, S, 64)).astype(np.float32) * 0.3)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    cache = init_kv_cache(cfg, B, T)
    valid = jnp.zeros((B, T), bool)
    h_all, cache_all, _ = transformer_forward(cfg, params, x, pos, cache, valid)

    cache = init_kv_cache(cfg, B, T)
    valid = jnp.zeros((B, T), bool)
    outs = []
    for s in range(S):
        h, cache, valid = transformer_forward(
            cfg, params, x[:, s : s + 1], pos[:, s : s + 1], cache, valid
        )
        outs.append(np.asarray(h)[:, 0])
    np.testing.assert_allclose(
        np.stack(outs, axis=1), np.asarray(h_all), rtol=2e-4, atol=2e-5
    )
    np.testing.assert_array_equal(
        np.asarray(cache.k), np.asarray(cache_all.k)
    )
    np.testing.assert_allclose(
        np.asarray(cache.k_scale), np.asarray(cache_all.k_scale), rtol=1e-6
    )


def test_splice_kv_cache_quantized():
    cfg = _tiny_tr(True)
    pool = init_kv_cache(cfg, 4, 8)
    one = init_kv_cache(cfg, 1, 8)
    one = one._replace(
        k=jnp.ones_like(one.k), k_scale=jnp.full_like(one.k_scale, 0.5),
        length=jnp.full((1,), 3, jnp.int32),
    )
    out = splice_kv_cache(pool, one, jnp.asarray(2, jnp.int32))
    assert np.asarray(out.k)[:, 2].min() == 1
    assert np.asarray(out.k)[:, 1].max() == 0
    assert np.asarray(out.k_scale)[:, 2].min() == 0.5
    assert int(np.asarray(out.length)[2]) == 3


@pytest.fixture(scope="module")
def kvq_engines(tiny_model, tiny_vocab_files):
    from leaxer_qwen3_tts_tpu.api.engine import TTSEngine
    from leaxer_qwen3_tts_tpu.frontend import Tokenizer

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    tok = Tokenizer(vocab_path, merges_path)
    kw = dict(config=cfg, params=params, tokenizer=tok, max_frames=12,
              chunk_len=4, first_chunk_len=2)
    plain = TTSEngine(**kw)
    kvq = TTSEngine(**kw, kv_quant=True)
    assert plain.is_ready() and kvq.is_ready(), (
        plain.get_error(), kvq.get_error()
    )
    return plain, kvq


def test_engine_kv_quant_e2e(kvq_engines):
    _, kvq = kvq_engines
    r = kvq.synthesize("hello world", temperature=0.0, seed=1)
    assert r.audio.size > 0 and np.isfinite(r.audio).all()
    assert r.codes.shape[1] == 16
    # determinism: same seed -> same codes
    r2 = kvq.synthesize("hello world", temperature=0.0, seed=1)
    np.testing.assert_array_equal(np.asarray(r.codes), np.asarray(r2.codes))


def test_engine_kv_quant_spec_matches_sequential(tiny_model, tiny_vocab_files):
    """Greedy spec decode == greedy sequential decode with the SAME int8 KV
    cache (both read identical quantized values, so the speculative
    exactness guarantee must survive quantization)."""
    from leaxer_qwen3_tts_tpu.api.engine import TTSEngine
    from leaxer_qwen3_tts_tpu.frontend import Tokenizer

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    tok = Tokenizer(vocab_path, merges_path)
    kw = dict(config=cfg, params=params, tokenizer=tok, max_frames=10,
              chunk_len=4, first_chunk_len=2, kv_quant=True)
    seq = TTSEngine(**kw)
    spec = TTSEngine(**kw, spec_k=3, spec_iters=2)
    a = seq.synthesize("hello world", temperature=0.0, seed=5)
    b = spec.synthesize("hello world", temperature=0.0, seed=5)
    np.testing.assert_array_equal(np.asarray(b.codes), np.asarray(a.codes))


def test_engine_kv_quant_bucket_growth(tiny_model, tiny_vocab_files):
    """KV ladder growth pads the scale arrays alongside the int8 cache."""
    from leaxer_qwen3_tts_tpu.api.engine import TTSEngine
    from leaxer_qwen3_tts_tpu.frontend import Tokenizer

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    tok = Tokenizer(vocab_path, merges_path)
    # tiny buckets force a mid-request migration
    eng = TTSEngine(config=cfg, params=params, tokenizer=tok, max_frames=24,
                    chunk_len=4, first_chunk_len=2, kv_buckets=(16, 32),
                    kv_quant=True)
    assert eng.is_ready(), eng.get_error()
    r = eng.synthesize("hello world", temperature=0.0, seed=0)
    assert r.metrics.frames > 0 and np.isfinite(r.audio).all()


def test_pool_kv_quant(tiny_model, tiny_vocab_files):
    from leaxer_qwen3_tts_tpu.api.engine import TTSEngine
    from leaxer_qwen3_tts_tpu.frontend import Tokenizer
    from leaxer_qwen3_tts_tpu.serve.pool import ContinuousBatcher

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    tok = Tokenizer(vocab_path, merges_path)
    eng = TTSEngine(config=cfg, params=params, tokenizer=tok, max_frames=10,
                    chunk_len=2, kv_quant=True)
    assert eng.is_ready(), eng.get_error()
    pool = ContinuousBatcher(eng, pool_size=2, chunk_len=2, kv_bucket=64,
                             text_bucket_max=16)
    try:
        r = pool.synthesize("hello world", temperature=0.0, max_tokens=6)
        assert len(r.codes) > 0 and np.isfinite(r.audio).all()
    finally:
        pool.shutdown()
