"""Model / runtime configuration for the JAX Qwen3-TTS framework.

Mirrors the capability surface of the reference engine's compile-time constants
(reference: src/tts_onnx.h:29-70 ``namespace config``) but as runtime dataclasses so
multiple model variants (0.6B-Base, 1.7B-VoiceDesign/CustomVoice) share one codebase.

Everything here is static metadata: hashable frozen dataclasses that can be used as
``jax.jit`` static arguments.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Token-ID vocabulary (parity with reference src/tts_onnx.h:39-62)
# ---------------------------------------------------------------------------

# TTS special tokens (text-vocab side)
TTS_BOS = 151672
TTS_EOS = 151673
TTS_PAD = 151671

# Chat tokens
IM_START = 151644
IM_END = 151645
ASSISTANT = 77091

# Codec control tokens (codec-vocab side; ids 2048..3071 are control/special)
CODEC_BOS = 2149
CODEC_EOS = 2150
CODEC_PAD = 2148
CODEC_THINK = 2154
CODEC_NOTHINK = 2155
CODEC_THINK_BOS = 2156
CODEC_THINK_EOS = 2157

# Language IDs (codec tokens, reference src/tts_onnx.h:58-62)
LANG_ENGLISH = 2050
LANG_CHINESE = 2051
LANG_JAPANESE = 2052
LANG_KOREAN = 2053

# Audio
SAMPLE_RATE = 24000
FRAME_RATE = 12  # codec frames per second
SAMPLES_PER_FRAME = SAMPLE_RATE // FRAME_RATE  # 2000

# Defaults (reference src/tts_onnx.h:64-68)
MAX_NEW_TOKENS = 2048
DEFAULT_TEMPERATURE = 0.8
DEFAULT_TOP_P = 0.95
DEFAULT_TOP_K = 50

LANGUAGES = {
    "auto": None,
    "en": LANG_ENGLISH,
    "english": LANG_ENGLISH,
    "zh": LANG_CHINESE,
    "chinese": LANG_CHINESE,
    "ja": LANG_JAPANESE,
    "japanese": LANG_JAPANESE,
    "ko": LANG_KOREAN,
    "korean": LANG_KOREAN,
}


def language_to_codec_id(lang: Optional[str]) -> Optional[int]:
    """Language name -> codec token id; None for auto (reference tts_onnx.h:230-238)."""
    if lang is None:
        return None
    key = lang.lower()
    if key not in LANGUAGES:
        raise ValueError(f"unknown language {lang!r}; expected one of {sorted(LANGUAGES)}")
    return LANGUAGES[key]


def _dtype(name: str):
    return {"bfloat16": jnp.bfloat16, "float32": jnp.float32, "float16": jnp.float16}[name]


# ---------------------------------------------------------------------------
# Architecture configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TransformerConfig:
    """A causal GQA transformer (Qwen3-style: RMSNorm, SwiGLU, RoPE, QK-norm).

    Used for both the talker (28 layers) and the code predictor (small) — the
    reference runs these as opaque ONNX graphs (talker_prefill/talker_decode at
    tts_onnx.cpp:615-732, code_predictor at :734-757); here they are one shared
    transformer implementation.
    """

    hidden_size: int = 1024
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # QK RMSNorm per head (Qwen3 style)
    use_qk_norm: bool = True
    # int8 KV cache with per-slot-per-head scales (models/layers.py KVCache):
    # halves the cache bytes that bind B>=16 serving and long-form decode.
    # Runtime choice (engine --kv-quant flips the talker's flag); checkpoints
    # are unaffected.
    kv_cache_quant: bool = False

    @property
    def jnp_dtype(self):
        return _dtype(self.dtype)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class TalkerConfig:
    """The autoregressive "talker": codec-token LM over 3072-way codec vocab.

    Architecture dims per reference src/tts_onnx.h:31-35 (HIDDEN_SIZE=1024,
    NUM_LAYERS=28, NUM_KV_HEADS=8, HEAD_DIM=128, VOCAB_SIZE=3072).
    """

    transformer: TransformerConfig = TransformerConfig()
    codec_vocab_size: int = 3072  # codebook-0 tokens 0..2047 + control 2048..3071
    text_vocab_size: int = 151936  # Qwen2.5/Qwen3 BPE text vocab
    # text_project: Embed(text_vocab, text_embed_dim) -> Dense(hidden).  If
    # text_embed_dim == hidden_size the Dense is still applied (projection is part
    # of the reference text_project.onnx contract, tts_onnx.cpp:545-559).
    text_embed_dim: int = 1024

    @property
    def hidden_size(self) -> int:
        return self.transformer.hidden_size


@dataclass(frozen=True)
class CodePredictorConfig:
    """MTP head predicting sub-codebooks 1..15 from the talker's last hidden state.

    Contract per reference tts_onnx.cpp:734-757 and :851-872: a growing 2..17-token
    sequence, ``generation_step``-indexed embedding tables (code_predictor_embed.onnx)
    and a 2048-way logits head per step.
    """

    transformer: TransformerConfig = TransformerConfig(
        hidden_size=1024,
        num_layers=6,
        num_heads=8,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=3072,
    )
    num_steps: int = 15  # sub-codebooks 1..15 (reference NUM_CODE_GROUPS-1)
    subcode_vocab_size: int = 2048  # reference SUBCODE_VOCAB_SIZE (tts_onnx.h:37)
    max_seq_len: int = 17  # [talker_hidden, codec_embed(code0), 15 sub-embeds]
    # Selectable head topology (docs/FALSIFIABILITY.md §2): "per_step" is the
    # primary guess (15 step-indexed 2048-way output heads — the reference's
    # ``generation_step`` input, tts_onnx.cpp:734-757); "shared" is the
    # pre-built fallback — ONE shared head plus a learned step embedding
    # added to the transformer input that produces each step's logits.  The
    # step-indexed EMBEDDING tables stay either way (they are the observable
    # code_predictor_embed.onnx contract, :592-613).
    head_mode: str = "per_step"  # "per_step" | "shared"
    # "cached": incremental KV per step; "dense": re-run the tiny <=17-token
    # sequence each step (same HBM bytes, fewer ops — see predict_subcodes_dense)
    impl: str = "cached"


@dataclass(frozen=True)
class VocoderConfig:
    """12 Hz neural codec decoder: 16 codebooks per frame -> 24 kHz waveform.

    Contract per reference tokenizer12hz_decode.onnx (tts_onnx.cpp:759-776):
    audio_codes i64 [1, frames, 16] -> audio f32, 2000 samples per frame.
    All convolutions are causal so the decoder can stream chunk-by-chunk.
    """

    num_codebooks: int = 16
    codebook_size: int = 2048
    d_model: int = 1024
    num_prenet_blocks: int = 4
    prenet_kernel_size: int = 5
    upsample_rates: Tuple[int, ...] = (10, 8, 5, 5)  # product == 2000 samples/frame
    upsample_channels: Tuple[int, ...] = (512, 256, 128, 64)
    resblock_kernel_size: int = 7
    resblock_dilations: Tuple[int, ...] = (1, 3)
    final_kernel_size: int = 7
    dtype: str = "bfloat16"
    # Selectable head topology (docs/FALSIFIABILITY.md §1): "conv" is the
    # primary guess (causal sub-pixel upsample stack above); "istft" is the
    # pre-built fallback — Vocos-style mag/phase spectrogram head at frame
    # rate + overlap-add inverse STFT (still causal: frame f's synthesis
    # window covers samples [f*hop, f*hop + n_fft), so sample block t only
    # reads frames t-overlap..t).  Real-weight bring-up selects by config —
    # no new model code either way.
    head: str = "conv"  # "conv" | "istft"
    istft_overlap: int = 4  # n_fft = overlap * samples_per_frame (hop)

    @property
    def jnp_dtype(self):
        return _dtype(self.dtype)

    @property
    def samples_per_frame(self) -> int:
        total = 1
        for r in self.upsample_rates:
            total *= r
        return total

    @property
    def left_context_frames(self) -> int:
        """Frames of left context after which chunked decoding is bit-exact.

        Receptive field of the causal stack expressed in input frames: prenet
        blocks contribute (k-1) frames each; post-upsample convs contribute
        (k-1)*dilation samples at their stage's sample rate, which shrinks to a
        fraction of a frame after division by the cumulative upsample factor.
        """
        ctx = self.num_prenet_blocks * (self.prenet_kernel_size - 1)
        if self.head == "istft":
            # the OLA window spans istft_overlap frames: sample block t sums
            # windowed frames t-(overlap-1)..t
            return ctx + self.istft_overlap - 1
        # upsampler input convs (kernel 3, causal) run at frame rate pre-reshape
        ctx += len(self.upsample_rates) * 2
        # resblocks + final conv, counted conservatively at their sample stage
        samples = 0.0
        up = 1
        for r in self.upsample_rates:
            up *= r
            per_stage = 0
            for d in self.resblock_dilations:
                per_stage += 2 * (self.resblock_kernel_size - 1) * d  # 2 convs/branch
            samples += per_stage / up
        samples += (self.final_kernel_size - 1) / up
        import math

        return ctx + math.ceil(samples)


@dataclass(frozen=True)
class SpeakerEncoderConfig:
    """Voice-clone speaker encoder: log-mel [T, 128] -> 1024-dim embedding.

    Contract per reference speaker_encoder.onnx (tts_onnx.cpp:367-403): input
    [1, num_frames, 128] mel, output [1024].
    """

    num_mels: int = 128
    d_model: int = 512
    num_layers: int = 4
    num_heads: int = 8
    intermediate_size: int = 2048
    output_dim: int = 1024
    dtype: str = "float32"
    # Selectable topology (docs/FALSIFIABILITY.md §3): "transformer" is the
    # primary guess (linear in_proj -> post-LN transformer -> attentive
    # stats pooling); "ecapa" is the pre-built fallback — an ECAPA-TDNN
    # x-vector encoder (conv frontend, SE-Res2Net blocks at dilations
    # 2/3/4, multi-layer feature aggregation, context-aware attentive
    # stats pooling).  Same [T, mels] -> [output_dim] contract either way
    # (reference tts_onnx.cpp:367-403).
    topology: str = "transformer"  # "transformer" | "ecapa"
    ecapa_channels: int = 512
    ecapa_scale: int = 8  # Res2Net split count
    ecapa_mfa_dim: int = 1536
    ecapa_att_dim: int = 128

    @property
    def jnp_dtype(self):
        return _dtype(self.dtype)


@dataclass(frozen=True)
class MelConfig:
    """Mel frontend config; defaults per reference tts_onnx.cpp:347-355."""

    sample_rate: int = 24000
    n_fft: int = 1024
    hop_size: int = 256
    win_size: int = 1024
    num_mels: int = 128
    fmin: float = 0.0
    fmax: float = 12000.0


@dataclass(frozen=True)
class DraftConfig:
    """Trained draft head for speculative decoding (models/draft.py).

    Optional: absent from the reference (inference-only, sequential loop);
    when a checkpoint carries draft params, the engine's spec_k path uses
    the model draft instead of the zero-cost repeat draft."""

    hidden_size: int = 1024  # talker hidden size it conditions on
    d_model: int = 512
    codec_vocab_size: int = 3072
    subcode_vocab_size: int = 2048
    num_codebooks: int = 16
    dtype: str = "bfloat16"

    @property
    def jnp_dtype(self):
        import jax.numpy as jnp

        return jnp.dtype(self.dtype)


@dataclass(frozen=True)
class TTSModelConfig:
    """Full model family bundle (one per variant: 0.6B-Base, 1.7B-*, ...)."""

    name: str = "qwen3-tts-12hz-0.6b-base"
    talker: TalkerConfig = TalkerConfig()
    code_predictor: CodePredictorConfig = CodePredictorConfig()
    vocoder: VocoderConfig = VocoderConfig()
    speaker_encoder: Optional[SpeakerEncoderConfig] = SpeakerEncoderConfig()
    mel: MelConfig = MelConfig()
    draft: Optional[DraftConfig] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TTSModelConfig":
        raw = json.loads(text)

        def build(tp, data):
            if data is None:
                return None
            kwargs = {}
            for f in dataclasses.fields(tp):
                if f.name not in data:
                    continue
                v = data[f.name]
                if dataclasses.is_dataclass(f.type) or f.name in (
                    "transformer",
                    "talker",
                    "code_predictor",
                    "vocoder",
                    "speaker_encoder",
                    "mel",
                    "draft",
                ):
                    sub = {
                        "transformer": TransformerConfig,
                        "talker": TalkerConfig,
                        "code_predictor": CodePredictorConfig,
                        "vocoder": VocoderConfig,
                        "speaker_encoder": SpeakerEncoderConfig,
                        "mel": MelConfig,
                        "draft": DraftConfig,
                    }[f.name]
                    kwargs[f.name] = build(sub, v)
                elif isinstance(v, list):
                    kwargs[f.name] = tuple(v)
                else:
                    kwargs[f.name] = v
            if tp is CodePredictorConfig and kwargs.get("impl") == "fused":
                # configs saved when a kernel chain existed: the chain it
                # named computed what the cached scan computes
                kwargs["impl"] = "cached"
            return tp(**kwargs)

        return build(cls, raw)


# Convenience preset: the 0.6B-Base model (the reference's only wired variant).
QWEN3_TTS_06B = TTSModelConfig()

# 1.7B-class variant (VoiceDesign / CustomVoice scale: wider talker).  Preset
# speakers (reference Speaker enum, tts_onnx.h:82-93) attach to this family.
QWEN3_TTS_17B = TTSModelConfig(
    name="qwen3-tts-12hz-1.7b",
    talker=TalkerConfig(
        transformer=TransformerConfig(
            hidden_size=2048,
            num_layers=28,
            num_heads=16,
            num_kv_heads=8,
            head_dim=128,
            intermediate_size=6144,
        ),
        text_embed_dim=2048,
    ),
    code_predictor=CodePredictorConfig(
        transformer=TransformerConfig(
            hidden_size=2048,
            num_layers=6,
            num_heads=16,
            num_kv_heads=8,
            head_dim=128,
            intermediate_size=6144,
        ),
    ),
)

PRESETS = {
    QWEN3_TTS_06B.name: QWEN3_TTS_06B,
    QWEN3_TTS_17B.name: QWEN3_TTS_17B,
}

# Preset speakers for CustomVoice models (reference tts_onnx.h:82-93).  The map is
# speaker name -> speaker id used to index the CustomVoice speaker-embedding table.
PRESET_SPEAKERS = {
    "serena": 0,
    "vivian": 1,
    "uncle_fu": 2,
    "dylan": 3,
    "eric": 4,
    "ryan": 5,
    "aiden": 6,
    "ono_anna": 7,
    "sohee": 8,
}
