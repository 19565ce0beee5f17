"""The serving path's talker (prefill, decode steps, the S=K verify pass)
against the plain float32 reference (models/reference.py), at tiny widths.

Covers what the GPU runs: batch 1/2/4 with per-stream positions, f32 / bf16 /
int8 / int4 weights, f32 and int8 KV, tight and long cache buckets, lockstep
and per-slot cache writes.  Quantised weights start from f32 here so the
comparison is exact up to summation order; bf16 keeps bf16 activations in the
path, hence its looser bound (the same bound chip_smoke.py applies).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from leaxer_qwen3_tts_tpu.models import reference

EXACT = 1e-4  # f32 on both sides at "highest" precision (conftest)


def _served(tiny_model, weights: str, kv: str):
    cfg, params = tiny_model
    dtype = "bfloat16" if weights == "bf16" else "float32"
    cfg_s = cs.with_dtype(cfg, dtype)
    if kv == "int8":
        cfg_s = cs.with_kv_quant(cfg_s)
    p = cs.cast_params(params, jnp.bfloat16 if weights == "bf16" else jnp.float32)
    p = cs.served_params(p, {"int8": "int8", "int4": "int4"}.get(weights))
    return cfg_s, p, reference.dequantize(p), jnp.dtype(dtype)


def _inputs(cfg, batch, lens, n_steps, dtype, seed=0):
    rng = np.random.default_rng(seed)
    H = cfg.talker.hidden_size
    P = max(lens)
    prompt = jnp.asarray(rng.standard_normal((batch, P, H)) * 0.5, dtype)
    steps = jnp.asarray(rng.standard_normal((batch, n_steps, H)) * 0.5, dtype)
    return prompt, jnp.asarray(lens, jnp.int32), steps


def _compare(got, want, weights):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    if weights == "bf16":
        assert cs.rel_l2(got, want) <= cs.SERVED_REL_L2
    else:
        assert cs.rel_linf(got, want) <= EXACT


TALKER_CASES = [
    # batch, prompt lengths, weights, kv, bucket, per-slot writes
    (1, [9], "f32", "f32", 32, False),
    (1, [9], "bf16", "f32", 32, False),
    (1, [9], "int8", "f32", 32, False),
    (1, [9], "int4", "f32", 32, False),
    (1, [9], "f32", "int8", 32, False),
    (1, [9], "int8", "int8", 32, False),
    (1, [9], "f32", "f32", 256, False),
    (1, [9], "int8", "int8", 256, False),
    (2, [9, 4], "f32", "f32", 32, False),
    (2, [9, 4], "bf16", "f32", 32, False),
    (2, [9, 4], "int8", "f32", 32, False),
    (2, [9, 4], "int4", "int8", 32, False),
    (2, [9, 4], "f32", "int8", 128, False),
    (2, [9, 4], "f32", "f32", 32, True),
    (4, [9, 6, 2, 8], "f32", "f32", 32, False),
    (4, [9, 6, 2, 8], "bf16", "f32", 32, False),
    (4, [9, 6, 2, 8], "int8", "int8", 32, False),
    (4, [9, 6, 2, 8], "int4", "f32", 64, False),
    (4, [9, 6, 2, 8], "f32", "f32", 32, True),
    (4, [9, 6, 2, 8], "int8", "int8", 64, True),
    (4, [9, 9, 9, 9], "f32", "f32", 256, False),
    (4, [9, 9, 9, 9], "bf16", "int8", 256, True),
]


@pytest.mark.parametrize(
    "batch,lens,weights,kv,bucket,per_slot", TALKER_CASES,
    ids=[f"B{c[0]}-{c[2]}-kv{c[3]}-T{c[4]}{'-slots' if c[5] else ''}" for c in TALKER_CASES],
)
def test_talker_decode_matches_reference(tiny_model, batch, lens, weights, kv,
                                         bucket, per_slot):
    """Prefill + 8 decode steps through the static cache == the reference
    over the whole sequence, read at the same positions."""
    cfg, p, ref, dt = _served(tiny_model, weights, kv)
    prompt, plen, steps = _inputs(cfg, batch, lens, 8, dt)
    got, cache = cs.talker_path_logits(
        cfg, p["talker"], prompt, plen, steps, bucket, uniform_fill=not per_slot
    )
    want = cs.talker_reference_logits(cfg, ref, prompt, plen, steps, kv_int8=kv == "int8")
    assert got.shape == (batch, 9, cfg.talker.codec_vocab_size)
    assert cache.quantized == (kv == "int8")
    _compare(got, want, weights)


VERIFY_CASES = [
    (1, [9], 2, "f32", "f32"),
    (1, [9], 4, "f32", "f32"),
    (1, [9], 4, "int8", "int8"),
    (1, [9], 4, "bf16", "f32"),
    (2, [9, 5], 2, "f32", "int8"),
    (2, [9, 5], 4, "int4", "f32"),
    (4, [9, 6, 2, 8], 4, "f32", "f32"),
    (4, [9, 6, 2, 8], 2, "int8", "int8"),
]


@pytest.mark.parametrize(
    "batch,lens,k,weights,kv", VERIFY_CASES,
    ids=[f"B{c[0]}-K{c[2]}-{c[3]}-kv{c[4]}" for c in VERIFY_CASES],
)
def test_verify_pass_matches_reference(tiny_model, batch, lens, k, weights, kv):
    """The speculative S=K verify pass (K tokens per talker forward) gives
    the reference's logits at every candidate position."""
    cfg, p, ref, dt = _served(tiny_model, weights, kv)
    prompt, plen, steps = _inputs(cfg, batch, lens, 8, dt, seed=1)
    got, _ = cs.talker_path_logits(cfg, p["talker"], prompt, plen, steps, 32, k=k)
    want = cs.talker_reference_logits(cfg, ref, prompt, plen, steps, kv_int8=kv == "int8")
    _compare(got, want, weights)


def test_reference_ignores_padding(tiny_model):
    """Right padding never changes the reference's logits for real tokens."""
    cfg, params = tiny_model
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((1, 6, cfg.talker.hidden_size)), jnp.float32)
    pad = jnp.concatenate([x[:, :4], 9.0 * jnp.ones_like(x[:, :2]), x[:, 4:]], axis=1)
    valid = jnp.asarray([[True] * 4 + [False] * 2 + [True] * 2])
    a = reference.talker_logits(cfg.talker, params["talker"], x)
    b = reference.talker_logits(cfg.talker, params["talker"], pad, valid)
    np.testing.assert_allclose(np.asarray(b)[:, [0, 1, 2, 3, 6, 7]], np.asarray(a), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_matches_quantized_matmul(bits):
    """dequantize() yields the values the quantised matmul multiplies by."""
    from leaxer_qwen3_tts_tpu.ops.quant import dense, quantize_weight, quantize_weight_int4

    rng = np.random.default_rng(bits)
    w = jnp.asarray(rng.standard_normal((256, 96)) * 0.05, jnp.float32)
    q = quantize_weight(w) if bits == 8 else quantize_weight_int4(w)
    x = jnp.asarray(rng.standard_normal((3, 256)), jnp.float32)
    deq = reference.dequantize({"w": q})["w"]
    assert deq.shape == w.shape and deq.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(x @ deq), np.asarray(dense(x, q)), rtol=1e-4, atol=1e-4)
    assert float(jnp.abs(deq - w).max()) <= float(jnp.abs(w).max()) / (7 if bits == 4 else 127)
