"""Fallback topologies for the three guessed graph architectures
(docs/FALSIFIABILITY.md): iSTFT/Vocos vocoder head, shared-head + step-
embedding code predictor, ECAPA-TDNN speaker encoder.

Each is config-selected so real-weight bring-up is a config flip whichever
guess the dump confirms (reference contracts: tts_onnx.cpp:759-776 vocoder,
:734-757/:851-872 code predictor, :367-403 speaker encoder).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from leaxer_qwen3_tts_tpu.config import (
    CodePredictorConfig,
    SpeakerEncoderConfig,
    TransformerConfig,
    VocoderConfig,
)


# ---------------------------------------------------------------- vocoder


@pytest.fixture(scope="module")
def istft_voc():
    from leaxer_qwen3_tts_tpu.models.codec12hz import init_vocoder_params

    cfg = VocoderConfig(
        d_model=32,
        num_prenet_blocks=2,
        upsample_rates=(10, 8, 5, 5),
        upsample_channels=(16, 16, 8, 8),
        dtype="float32",
        head="istft",
        istft_overlap=4,
    )
    params = init_vocoder_params(cfg, jax.random.PRNGKey(7))
    return cfg, params


def _codes(rng, B, F):
    return jnp.asarray(rng.integers(0, 2048, (B, F, 16)), jnp.int32)


def test_istft_shape_contract(istft_voc):
    from leaxer_qwen3_tts_tpu.models.codec12hz import vocoder_forward

    cfg, params = istft_voc
    rng = np.random.default_rng(0)
    codes = _codes(rng, 2, 6)
    audio = vocoder_forward(cfg, params, codes)
    # same 2000-samples/frame contract as the conv head (24 kHz / 12 Hz)
    assert audio.shape == (2, 6 * cfg.samples_per_frame)
    assert np.isfinite(np.asarray(audio)).all()


def test_istft_causality(istft_voc):
    """Sample block t only reads frames <= t (the synthesis window of frame f
    covers [f*hop, f*hop+n_fft)) — changing a future frame must not change
    past audio."""
    from leaxer_qwen3_tts_tpu.models.codec12hz import vocoder_forward

    cfg, params = istft_voc
    rng = np.random.default_rng(1)
    codes = _codes(rng, 1, 8)
    a1 = np.asarray(vocoder_forward(cfg, params, codes))
    codes2 = codes.at[0, 6, :].set((codes[0, 6, :] + 11) % 2048)
    a2 = np.asarray(vocoder_forward(cfg, params, codes2))
    spf = cfg.samples_per_frame
    # prenet is causal with its own context; frame 6 can affect blocks >= 6
    np.testing.assert_array_equal(a1[:, : 6 * spf], a2[:, : 6 * spf])
    assert not np.array_equal(a1[:, 6 * spf :], a2[:, 6 * spf :])


def test_istft_chunked_streaming_exact(istft_voc):
    """Chunked decode with >= left_context_frames of context reproduces the
    one-shot waveform exactly — the same streaming contract as the conv head
    (engine chunks carry left_context_frames)."""
    from leaxer_qwen3_tts_tpu.models.codec12hz import (
        vocode_chunk,
        vocoder_forward,
    )

    cfg, params = istft_voc
    ctx = cfg.left_context_frames
    rng = np.random.default_rng(2)
    F, chunk = 2 * ctx + 9, 5
    codes = _codes(rng, 1, F)
    full = np.asarray(vocoder_forward(cfg, params, codes))

    out = []
    start = 0
    while start < F:
        end = min(start + chunk, F)
        c0 = max(0, start - ctx)
        got = vocode_chunk(cfg, params, codes[:, c0:end], start - c0)
        out.append(np.asarray(got))
        start = end
    streamed = np.concatenate(out, axis=1)
    np.testing.assert_allclose(streamed, full, rtol=0, atol=1e-5)


def test_istft_left_context_covers_overlap(istft_voc):
    cfg, _ = istft_voc
    conv_cfg = dataclasses.replace(cfg, head="conv")
    # the OLA tail adds overlap-1 frames on top of the prenet context
    assert cfg.left_context_frames >= cfg.istft_overlap - 1


# ---------------------------------------------------------- code predictor


@pytest.fixture(scope="module")
def shared_cp():
    from leaxer_qwen3_tts_tpu.models.code_predictor import (
        init_code_predictor_params,
    )

    cfg = CodePredictorConfig(
        transformer=TransformerConfig(
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=4,
            head_dim=16,
            intermediate_size=128,
            dtype="float32",
        ),
        num_steps=15,
        subcode_vocab_size=2048,
        head_mode="shared",
    )
    params = init_code_predictor_params(cfg, jax.random.PRNGKey(3))
    tables = (
        jax.random.normal(
            jax.random.PRNGKey(4),
            (cfg.num_steps, cfg.subcode_vocab_size, 64),
            jnp.float32,
        )
        * 0.02
    )
    return cfg, params, tables


def test_shared_head_params(shared_cp):
    cfg, params, _ = shared_cp
    assert "heads" not in params
    assert params["head"].shape == (64, cfg.subcode_vocab_size)
    assert params["step_embed"].shape == (cfg.num_steps, 64)


def _greedy(key, logits):
    return jnp.argmax(logits, axis=-1).astype(jnp.int32)


def test_shared_head_shapes_and_determinism(shared_cp):
    from leaxer_qwen3_tts_tpu.models.code_predictor import predict_subcodes

    cfg, params, tables = shared_cp
    B, H = 2, 64
    k = jax.random.PRNGKey(0)
    lh = jax.random.normal(jax.random.PRNGKey(10), (B, H), jnp.float32)
    c0 = jax.random.normal(jax.random.PRNGKey(11), (B, H), jnp.float32)
    subs, esum = predict_subcodes(cfg, params, tables, lh, c0, k, _greedy)
    assert subs.shape == (B, cfg.num_steps) and subs.dtype == jnp.int32
    assert esum.shape == (B, H)
    assert (np.asarray(subs) >= 0).all()
    assert (np.asarray(subs) < cfg.subcode_vocab_size).all()
    subs2, esum2 = predict_subcodes(cfg, params, tables, lh, c0, k, _greedy)
    np.testing.assert_array_equal(np.asarray(subs), np.asarray(subs2))


def test_shared_head_cached_vs_dense_agree(shared_cp):
    """The cached and dense impls must agree under the shared-head topology
    too (same step-conditioning applied in both)."""
    from leaxer_qwen3_tts_tpu.models.code_predictor import predict_subcodes

    cfg, params, tables = shared_cp
    B, H = 2, 64
    k = jax.random.PRNGKey(5)
    lh = jax.random.normal(jax.random.PRNGKey(12), (B, H), jnp.float32)
    c0 = jax.random.normal(jax.random.PRNGKey(13), (B, H), jnp.float32)
    s_cached, e_cached = predict_subcodes(cfg, params, tables, lh, c0, k, _greedy)
    dense_cfg = dataclasses.replace(cfg, impl="dense")
    s_dense, e_dense = predict_subcodes(dense_cfg, params, tables, lh, c0, k, _greedy)
    np.testing.assert_array_equal(np.asarray(s_cached), np.asarray(s_dense))
    np.testing.assert_allclose(
        np.asarray(e_cached), np.asarray(e_dense), rtol=0, atol=2e-4
    )


def test_shared_head_step_conditioning_matters(shared_cp):
    """Zeroing the step embedding must change the sampled sub-codes — the
    conditioning is real, not a dead input."""
    from leaxer_qwen3_tts_tpu.models.code_predictor import predict_subcodes

    cfg, params, tables = shared_cp
    B, H = 1, 64
    k = jax.random.PRNGKey(6)
    lh = jax.random.normal(jax.random.PRNGKey(14), (B, H), jnp.float32)
    c0 = jax.random.normal(jax.random.PRNGKey(15), (B, H), jnp.float32)
    s1, _ = predict_subcodes(cfg, params, tables, lh, c0, k, _greedy)
    p0 = dict(params)
    p0["step_embed"] = jnp.zeros_like(params["step_embed"])
    s2, _ = predict_subcodes(cfg, p0, tables, lh, c0, k, _greedy)
    assert not np.array_equal(np.asarray(s1), np.asarray(s2))


# --------------------------------------------------------- speaker encoder


@pytest.fixture(scope="module")
def ecapa_enc():
    from leaxer_qwen3_tts_tpu.models.speaker_encoder import (
        init_speaker_encoder_params,
    )

    cfg = SpeakerEncoderConfig(
        d_model=32,
        num_layers=1,
        num_heads=4,
        intermediate_size=64,
        output_dim=64,
        topology="ecapa",
        ecapa_channels=32,
        ecapa_scale=4,
        ecapa_mfa_dim=48,
        ecapa_att_dim=16,
    )
    params = init_speaker_encoder_params(cfg, jax.random.PRNGKey(9))
    return cfg, params


def test_ecapa_shape_contract(ecapa_enc):
    from leaxer_qwen3_tts_tpu.models.speaker_encoder import (
        speaker_encoder_forward,
    )

    cfg, params = ecapa_enc
    mel = jax.random.normal(jax.random.PRNGKey(20), (2, 37, cfg.num_mels))
    emb = speaker_encoder_forward(cfg, params, mel)
    assert emb.shape == (2, cfg.output_dim)
    assert np.isfinite(np.asarray(emb)).all()


def test_ecapa_padding_invariance(ecapa_enc):
    """Padding frames beyond mel_len must not change the embedding (masked
    convs + masked pooling)."""
    from leaxer_qwen3_tts_tpu.models.speaker_encoder import (
        speaker_encoder_forward,
    )

    cfg, params = ecapa_enc
    T = 29
    mel = jax.random.normal(jax.random.PRNGKey(21), (1, T, cfg.num_mels))
    ln = jnp.asarray([T - 8], jnp.int32)
    e1 = speaker_encoder_forward(cfg, params, mel, ln)
    mel2 = mel.at[:, T - 8 :, :].set(123.0)  # garbage in the padded region
    e2 = speaker_encoder_forward(cfg, params, mel2, ln)
    # the input and every block output are masked, so all convs read zeros
    # past mel_len — exact invariance
    np.testing.assert_allclose(
        np.asarray(e1), np.asarray(e2), rtol=0, atol=1e-5
    )


def test_ecapa_differs_by_input(ecapa_enc):
    from leaxer_qwen3_tts_tpu.models.speaker_encoder import (
        speaker_encoder_forward,
    )

    cfg, params = ecapa_enc
    m1 = jax.random.normal(jax.random.PRNGKey(22), (1, 31, cfg.num_mels))
    m2 = jax.random.normal(jax.random.PRNGKey(23), (1, 31, cfg.num_mels))
    e1 = np.asarray(speaker_encoder_forward(cfg, params, m1))
    e2 = np.asarray(speaker_encoder_forward(cfg, params, m2))
    assert not np.allclose(e1, e2)
