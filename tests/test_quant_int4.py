"""int4 (group-128, nibble-packed) weight quantization: packing layout and
the XLA dense path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from leaxer_qwen3_tts_tpu.config import TalkerConfig, TransformerConfig
from leaxer_qwen3_tts_tpu.ops.quant import (
    INT4_GROUP,
    QuantizedLinear4,
    dense,
    quantize_weight_int4,
    unpack_int4,
)


def _talker_cfg():
    t = TransformerConfig(
        hidden_size=1024, num_layers=1, num_heads=8, num_kv_heads=4,
        head_dim=128, intermediate_size=3072, dtype="float32",
    )
    return TalkerConfig(transformer=t, codec_vocab_size=256,
                        text_vocab_size=152000)


def test_int4_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=(512, 256)).astype(np.float32) * 0.05)
    q4 = quantize_weight_int4(w)
    assert q4.q.shape == (256, 256) and q4.q.dtype == jnp.int8
    assert q4.scale.shape == (512 // INT4_GROUP, 256)
    vals = np.asarray(unpack_int4(q4.q))
    assert vals.min() >= -8 and vals.max() <= 7
    # dequant error bounded by half a quantization step per element
    s_full = np.repeat(np.asarray(q4.scale), INT4_GROUP, axis=0)
    err = np.abs(vals * s_full - np.asarray(w))
    assert (err <= s_full / 2 + 1e-7).all()


def test_int4_rejects_odd_k():
    with pytest.raises(ValueError, match="even K"):
        quantize_weight_int4(jnp.zeros((101, 8)))


def test_int4_even_k_indivisible_by_group_shrinks_group():
    # K=320 with the default group 128: gcd(128, 160) = 32 -> still quantizes
    rng = np.random.default_rng(7)
    w = jnp.asarray(rng.normal(size=(320, 8)).astype(np.float32))
    q4 = quantize_weight_int4(w)
    assert q4.q.shape == (160, 8)
    assert q4.scale.shape[0] == 320 // 32  # group shrank to 32
    deq = np.asarray(unpack_int4(q4.q)).astype(np.float32) * np.repeat(
        np.asarray(q4.scale), 32, axis=0
    )
    assert np.abs(deq - np.asarray(w)).max() <= np.abs(np.asarray(w)).max() / 7.0


def test_dense_int4_matches_dequant_matmul():
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.normal(size=(1024, 512)).astype(np.float32) * 0.03)
    q4 = quantize_weight_int4(w)
    deq = np.asarray(unpack_int4(q4.q)).astype(np.float32) * np.repeat(
        np.asarray(q4.scale), INT4_GROUP, axis=0
    )
    x = jnp.asarray(rng.normal(size=(3, 1024)).astype(np.float32))
    y = np.asarray(dense(x, q4))
    yref = np.asarray(x) @ deq
    rel = np.abs(y - yref).max() / np.abs(yref).max()
    assert rel < 2e-2, rel


def test_quantize_params_int4_layout():
    """bits=4 gives int4 transformer matmuls but keeps lm_head/heads int8."""
    from leaxer_qwen3_tts_tpu.models.talker import init_talker_params
    from leaxer_qwen3_tts_tpu.ops.quant import (
        QuantizedLinear,
        fuse_params,
        quantize_params,
    )

    params = init_talker_params(_talker_cfg(), jax.random.PRNGKey(0))
    q = quantize_params(fuse_params({"talker": params}), bits=4)["talker"]
    layers = q["transformer"]["layers"]
    assert isinstance(layers["wqkv"], QuantizedLinear4)
    assert isinstance(layers["wd"], QuantizedLinear4)
    assert isinstance(q["lm_head"], QuantizedLinear)  # int8, not int4


def test_engine_int4_end_to_end(tiny_model, tiny_vocab_files):
    """quantize='int4' engine synthesizes finite audio."""
    from leaxer_qwen3_tts_tpu.api.engine import TTSEngine
    from leaxer_qwen3_tts_tpu.frontend import Tokenizer

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    eng = TTSEngine(
        config=cfg, params=params,
        tokenizer=Tokenizer(vocab_path, merges_path),
        max_frames=8, chunk_len=4, quantize="int4",
    )
    assert eng.is_ready(), eng.get_error()
    res = eng.synthesize("hello int4 world", max_tokens=6)
    audio = np.asarray(res.audio)
    assert audio.size > 0 and np.isfinite(audio).all()
