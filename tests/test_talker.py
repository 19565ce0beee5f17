"""Talker correctness: prefill/decode parity, padding invariance, cache semantics.

This is the analog of the reference's (absent) end-to-end numerical
tests — SURVEY §4 notes the reference CI never exercises a real model; here the
incremental-decode path is held to exact agreement with the one-shot prefill
path, which is the property the reference's talker_prefill/talker_decode ONNX
pair must satisfy by construction.
"""

import jax
import jax.numpy as jnp
import pytest

from leaxer_qwen3_tts_tpu.config import TalkerConfig, TransformerConfig
from leaxer_qwen3_tts_tpu.models.talker import (
    init_talker_params,
    talker_decode_step,
    talker_init_cache,
    talker_prefill,
    talker_prefill_all_logits,
)


@pytest.fixture(scope="module")
def setup():
    tcfg = TransformerConfig(
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        intermediate_size=128,
        dtype="float32",
    )
    cfg = TalkerConfig(
        transformer=tcfg, codec_vocab_size=32, text_vocab_size=100, text_embed_dim=64
    )
    params = init_talker_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


def test_prefill_decode_parity(setup):
    """Prefill over N tokens == prefill over k + (N-k) single decode steps."""
    cfg, params = setup
    B, P, H = 2, 6, 64
    embeds = jax.random.normal(jax.random.PRNGKey(1), (B, P, H), jnp.float32)
    plen = jnp.array([P, P], jnp.int32)

    cache = talker_init_cache(cfg, B, 16)
    logits_all, hidden_all, _, _ = talker_prefill_all_logits(cfg, params, embeds, plen, cache)

    cache2 = talker_init_cache(cfg, B, 16)
    l, h, cache2, vm = talker_prefill(cfg, params, embeds[:, :3], jnp.array([3, 3]), cache2)
    assert jnp.max(jnp.abs(l - logits_all[:, 2])) < 1e-4
    for i in range(3, P):
        l, h, cache2, vm = talker_decode_step(
            cfg, params, embeds[:, i], jnp.array([i, i]), cache2, vm
        )
        assert jnp.max(jnp.abs(l - logits_all[:, i])) < 1e-4, f"step {i}"
        assert jnp.max(jnp.abs(h - hidden_all[:, i])) < 1e-4, f"hidden step {i}"


def test_padded_prompt_invariance(setup):
    """Garbage beyond prompt_len must not affect logits at all (exact masking)."""
    cfg, params = setup
    B, P, H = 2, 6, 64
    embeds = jax.random.normal(jax.random.PRNGKey(1), (B, P, H), jnp.float32)
    plen = jnp.array([4, 6], jnp.int32)

    a = embeds.at[0, 4:].set(99.0)
    b = embeds.at[0, 4:].set(-777.0)
    la, _, _, _ = talker_prefill(cfg, params, a, plen, talker_init_cache(cfg, B, 16))
    lb, _, _, _ = talker_prefill(cfg, params, b, plen, talker_init_cache(cfg, B, 16))
    assert jnp.array_equal(la, lb)

    # and equals the unpadded run (same batch shape)
    l4, _, _, _ = talker_prefill(
        cfg, params, embeds[:, :4], jnp.array([4, 4]), talker_init_cache(cfg, B, 16)
    )
    assert jnp.max(jnp.abs(la[0] - l4[0])) < 1e-5


def test_decode_after_padded_prompt(setup):
    """Decode continuation after a right-padded prompt matches the unpadded run."""
    cfg, params = setup
    H = 64
    embeds = jax.random.normal(jax.random.PRNGKey(2), (1, 4, H), jnp.float32)
    step_embed = jax.random.normal(jax.random.PRNGKey(3), (1, H), jnp.float32)

    # unpadded
    c1 = talker_init_cache(cfg, 1, 16)
    l1, h1, c1, v1 = talker_prefill(cfg, params, embeds, jnp.array([4]), c1)
    d1, _, _, _ = talker_decode_step(cfg, params, step_embed, jnp.array([4]), c1, v1)

    # padded to 6
    padded = jnp.concatenate([embeds, jnp.full((1, 2, H), 5.0)], axis=1)
    c2 = talker_init_cache(cfg, 1, 16)
    l2, h2, c2, v2 = talker_prefill(cfg, params, padded, jnp.array([4]), c2)
    d2, _, _, _ = talker_decode_step(cfg, params, step_embed, jnp.array([4]), c2, v2)

    assert jnp.max(jnp.abs(l1 - l2)) < 1e-5
    assert jnp.max(jnp.abs(d1 - d2)) < 1e-5


def test_cache_length_advances(setup):
    cfg, params = setup
    B, P, H = 1, 5, 64
    embeds = jnp.zeros((B, P, H))
    cache = talker_init_cache(cfg, B, 16)
    assert int(cache.length[0]) == 0
    _, _, cache, vm = talker_prefill(cfg, params, embeds, jnp.array([P]), cache)
    assert int(cache.length[0]) == P
    _, _, cache, vm = talker_decode_step(cfg, params, embeds[:, 0], jnp.array([P]), cache, vm)
    assert int(cache.length[0]) == P + 1
    assert bool(vm[0, P])
    assert not bool(vm[0, P + 1])
