"""Qwen3-TTS framework in JAX / XLA.

A ground-up rebuild of the capabilities of leaxer-ai/leaxer-qwen3-tts in JAX:
text -> BPE tokens -> talker transformer (jitted prefill + device-resident-KV
decode) -> 16-codebook 12 Hz acoustic codes -> causal codec vocoder -> 24 kHz WAV,
with language control, on-device seeded sampling, and voice cloning.
"""

from . import config
from .config import (
    QWEN3_TTS_06B,
    QWEN3_TTS_17B,
    TTSModelConfig,
)

__version__ = "0.1.0"

__all__ = [
    "config",
    "TTSModelConfig",
    "QWEN3_TTS_06B",
    "QWEN3_TTS_17B",
    "TTSEngine",
    "SynthesisResult",
    "EngineError",
    "__version__",
]


def __getattr__(name):
    # engine pulls in the whole model stack; import lazily
    if name in ("TTSEngine", "SynthesisResult", "EngineError"):
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
