"""The MTP chain and the streamed vocoder chunk against the plain float32
reference (models/reference.py), at tiny widths, plus chip_smoke.py's
correctness phase run end to end on the tiny model."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from leaxer_qwen3_tts_tpu.models import reference
from leaxer_qwen3_tts_tpu.models.code_predictor import init_code_predictor_params

EXACT = 1e-4


MTP_CASES = [
    # batch, weights, head topology
    (1, "f32", "per_step"),
    (1, "bf16", "per_step"),
    (1, "int8", "per_step"),
    (1, "int4", "per_step"),
    (2, "f32", "per_step"),
    (2, "int8", "per_step"),
    (4, "f32", "per_step"),
    (4, "bf16", "per_step"),
    (4, "int4", "per_step"),
    (1, "f32", "shared"),
    (2, "int8", "shared"),
    (4, "bf16", "shared"),
]


@pytest.mark.parametrize(
    "batch,weights,head_mode", MTP_CASES,
    ids=[f"B{c[0]}-{c[1]}-{c[2]}" for c in MTP_CASES],
)
def test_mtp_chain_matches_reference(tiny_model, batch, weights, head_mode):
    """The cached 15-step chain's logits == the reference teacher-forced on
    the chain's own (greedy) sub-codes; the sub-codes are the logits' argmax."""
    cfg, params = tiny_model
    cfg = dataclasses.replace(
        cfg, code_predictor=dataclasses.replace(cfg.code_predictor, head_mode=head_mode)
    )
    if head_mode == "shared":
        params = dict(params, code_predictor=init_code_predictor_params(
            cfg.code_predictor, jax.random.PRNGKey(7)))
    dtype = jnp.bfloat16 if weights == "bf16" else jnp.float32
    cfg_s = cs.with_dtype(cfg, "bfloat16" if weights == "bf16" else "float32")
    p = cs.served_params(cs.cast_params(params, dtype),
                         {"int8": "int8", "int4": "int4"}.get(weights))
    ref = reference.dequantize(p)
    rng = np.random.default_rng(batch)
    H = cfg.talker.hidden_size
    lh = jnp.asarray(rng.standard_normal((batch, H)), dtype)
    c0 = jnp.asarray(rng.standard_normal((batch, H)) * 0.02, dtype)
    subs, got = cs.mtp_path_logits(cfg_s, p, lh, c0)
    want = cs.mtp_reference_logits(cfg_s, ref, lh, c0, subs)
    n, V = cfg.code_predictor.num_steps, cfg.code_predictor.subcode_vocab_size
    assert subs.shape == (batch, n) and got.shape == (batch, n, V)
    np.testing.assert_array_equal(np.asarray(subs), np.argmax(np.asarray(got), -1))
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if weights == "bf16":
        assert cs.rel_l2(got, want) <= cs.SERVED_REL_L2
    else:
        assert cs.rel_linf(got, want) <= EXACT


@pytest.mark.parametrize("frames,dtype", [(1, "float32"), (4, "float32"), (8, "float32"),
                                          (4, "bfloat16"), (8, "bfloat16")])
def test_vocoder_chunk_matches_reference(tiny_model, frames, dtype):
    """A streamed chunk (left context = left_context_frames) == the
    reference's whole-utterance audio over the same samples."""
    cfg, params = tiny_model
    cfg_s = cs.with_dtype(cfg, dtype)
    p = cs.cast_params(params, jnp.dtype(dtype))
    ctx = cfg.vocoder.left_context_frames
    rng = np.random.default_rng(frames)
    codes = jnp.asarray(rng.integers(0, 2048, (1, ctx + frames, 16)), jnp.int32)
    got, want = cs.vocoder_pair(cfg_s, p, reference.dequantize(p), codes, ctx)
    assert got.shape == (1, frames * cfg.vocoder.samples_per_frame)
    if dtype == "bfloat16":
        assert cs.rel_l2(got, want) <= cs.SERVED_REL_L2
    else:
        assert cs.rel_linf(got, want) <= EXACT


def test_reference_vocoder_is_causal(tiny_model):
    """Appending frames never changes the reference's earlier samples."""
    cfg, params = tiny_model
    rng = np.random.default_rng(5)
    codes = jnp.asarray(rng.integers(0, 2048, (1, 6, 16)), jnp.int32)
    a = reference.vocoder(cfg.vocoder, params["vocoder"], codes[:, :4])
    b = reference.vocoder(cfg.vocoder, params["vocoder"], codes)
    np.testing.assert_allclose(np.asarray(b)[:, : a.shape[1]], np.asarray(a), atol=1e-6)


@pytest.mark.parametrize(
    "variants,kw",
    [
        (("f32", "bf16"), {}),
        (("int8", "int4", "int8+kvq"), {"served_dtype": "float32"}),
        (("f32", "int8+kvq"), {"batch": 4, "prompt_lens": [12, 7, 3, 10],
                               "max_len": 64, "uniform_fill": False, "served_dtype": "float32"}),
    ],
    ids=["f32-bf16", "quantized", "B4-slots"],
)
def test_correctness_phase_tiny(tiny_model, variants, kw):
    """chip_smoke's correctness phase end to end: every gate passes and the
    numbers it reports are well inside them."""
    cfg, params = tiny_model
    out = cs.correctness("tiny", cfg, params, variants=variants, n_steps=8, **kw)
    assert set(out) == set(variants)
    for variant, res in out.items():
        assert res["talker"]["code0_argmax_agree"] == 1.0
        if variant == "f32":
            assert res["vocoder"]["rel_linf"] <= EXACT
            assert res["talker"]["rel_linf_default_precision"] <= EXACT
        elif kw.get("served_dtype") == "float32":
            assert res["talker"]["rel_l2"] <= EXACT and res["mtp"]["rel_l2"] <= EXACT


def test_correctness_phase_gate_fails_loudly(tiny_model, monkeypatch):
    """A path that drifts from the reference raises, naming the component."""
    cfg, params = tiny_model
    monkeypatch.setattr(cs, "F32_REL_LINF", -1.0)
    with pytest.raises(cs.SmokeError, match="f32 talker"):
        cs.correctness("tiny", cfg, params, variants=("f32",), n_steps=4)
