"""12 Hz neural codec decoder (vocoder): 16 codebooks/frame -> 24 kHz waveform.

I/O contract per the reference's tokenizer12hz_decode.onnx (tts_onnx.cpp:759-776):
codes i64 [B, frames, 16] -> audio f32 [B, frames * 2000] (+ valid lengths).

Architecture (weights-compatible via the converter's name mapping):
  * 16 codebook embedding tables, summed per frame -> [B, F, D]
  * prenet: ConvNeXt-style causal blocks at frame rate (depthwise causal conv +
    pointwise MLP) — all matmul-shaped
  * upsampling stages: causal conv (k=3) producing rate*channels, reshaped
    (sub-pixel / "pixel-shuffle") to rate x length — an exactly-causal
    transposed conv that lowers to one large matmul per stage
  * per-stage causal residual dilated conv blocks; final causal conv -> tanh

Every op is causal, so chunked decoding with ``left_context_frames`` of context
is exact — the streaming path the reference lacks (it vocodes once at the end,
tts_onnx.cpp:430).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import VocoderConfig


# ---------------------------------------------------------------------------
# Causal conv primitives (channels-last [B, T, C]; pad left only)
# ---------------------------------------------------------------------------


def causal_conv1d(x: jax.Array, w: jax.Array, dilation: int = 1) -> jax.Array:
    """x [B, T, Cin], w [K, Cin, Cout] -> [B, T, Cout]; left-padded (causal)."""
    k = w.shape[0]
    pad = (k - 1) * dilation
    out = jax.lax.conv_general_dilated(
        x,
        w,
        window_strides=(1,),
        padding=[(pad, 0)],
        rhs_dilation=(dilation,),
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.float32,
    )
    return out.astype(x.dtype)


def causal_dwconv1d(x: jax.Array, w: jax.Array) -> jax.Array:
    """Depthwise causal conv: x [B, T, C], w [K, C] -> [B, T, C]."""
    k, c = w.shape
    pad = k - 1
    out = jax.lax.conv_general_dilated(
        x,
        w[:, None, :],  # [K, 1, C] with feature_group_count=C
        window_strides=(1,),
        padding=[(pad, 0)],
        dimension_numbers=("NWC", "WIO", "NWC"),
        feature_group_count=c,
        preferred_element_type=jnp.float32,
    )
    return out.astype(x.dtype)


def layer_norm(x: jax.Array, scale: jax.Array, bias: jax.Array, eps: float = 1e-6) -> jax.Array:
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.var(xf, axis=-1, keepdims=True)
    y = (xf - mu) * jax.lax.rsqrt(var + eps)
    return (y * scale + bias).astype(x.dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _conv_init(key, k, cin, cout, dtype):
    scale = 1.0 / jnp.sqrt(k * cin)
    return (jax.random.normal(key, (k, cin, cout), jnp.float32) * scale).astype(dtype)


def init_vocoder_params(cfg: VocoderConfig, key: jax.Array) -> dict:
    dt = cfg.jnp_dtype
    d = cfg.d_model
    keys = iter(jax.random.split(key, 256))

    params = {
        "codebooks": (
            jax.random.normal(next(keys), (cfg.num_codebooks, cfg.codebook_size, d), jnp.float32)
            * 0.02
        ).astype(dt),
        "prenet": [],
    }
    for _ in range(cfg.num_prenet_blocks):
        params["prenet"].append(
            {
                "dw": (jax.random.normal(next(keys), (cfg.prenet_kernel_size, d), jnp.float32)
                       * (1.0 / cfg.prenet_kernel_size)).astype(dt),
                "ln_scale": jnp.ones((d,), jnp.float32),
                "ln_bias": jnp.zeros((d,), jnp.float32),
                "w1": _conv_init(next(keys), 1, d, 3 * d, dt)[0],
                "b1": jnp.zeros((3 * d,), dt),
                "w2": _conv_init(next(keys), 1, 3 * d, d, dt)[0],
                "b2": jnp.zeros((d,), dt),
            }
        )

    if cfg.head == "istft":
        # Vocos-style head: LayerNorm -> linear to n_fft + 2 channels
        # (magnitude + phase for n_fft//2 + 1 bins) at frame rate; the
        # iSTFT itself has no parameters beyond the synthesis window
        n_fft = cfg.istft_overlap * cfg.samples_per_frame
        n_bins = n_fft // 2 + 1
        params["head_ln_scale"] = jnp.ones((d,), jnp.float32)
        params["head_ln_bias"] = jnp.zeros((d,), jnp.float32)
        params["istft_out_w"] = _conv_init(next(keys), 1, d, 2 * n_bins, dt)[0]
        params["istft_out_b"] = jnp.zeros((2 * n_bins,), dt)
        return params

    params["stages"] = []
    cin = d
    for rate, cout in zip(cfg.upsample_rates, cfg.upsample_channels):
        stage = {
            "up_w": _conv_init(next(keys), 3, cin, cout * rate, dt),
            "up_b": jnp.zeros((cout * rate,), dt),
            "res": [],
        }
        for dil in cfg.resblock_dilations:
            stage["res"].append(
                {
                    "w1": _conv_init(next(keys), cfg.resblock_kernel_size, cout, cout, dt),
                    "b1": jnp.zeros((cout,), dt),
                    "w2": _conv_init(next(keys), cfg.resblock_kernel_size, cout, cout, dt),
                    "b2": jnp.zeros((cout,), dt),
                }
            )
        params["stages"].append(stage)
        cin = cout

    params["final_w"] = _conv_init(next(keys), cfg.final_kernel_size, cin, 1, dt)
    params["final_b"] = jnp.zeros((1,), dt)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def embed_codes(cfg: VocoderConfig, params: dict, codes: jax.Array) -> jax.Array:
    """codes [B, F, 16] int32 -> summed codebook embeddings [B, F, D]."""
    # one_hot-free gather per codebook, summed; codebook axis vectorized
    def gather(table, ids):
        return jnp.take(table, ids, axis=0)

    per_book = jax.vmap(gather, in_axes=(0, 2), out_axes=0)(params["codebooks"], codes)
    return jnp.sum(per_book, axis=0)  # [B, F, D]


def _istft_head(cfg: VocoderConfig, params: dict, x: jax.Array) -> jax.Array:
    """Vocos-style inverse-STFT head: frame-rate features [B, F, D] -> audio
    [B, F * hop].  Fallback topology for the reference vocoder
    (tts_onnx.cpp:759-776; docs/FALSIFIABILITY.md §1).

    Frame f's synthesis window covers samples [f*hop, f*hop + n_fft), so the
    output block for frame t sums windowed frames t-(overlap-1)..t — strictly
    left context, which keeps chunked streaming exact (same contract as the
    conv head).  Normalization follows torch.istft (window-square sum, NOLA),
    clamped at the global onset where the hann ramp starts at zero."""
    B, F, _ = x.shape
    hop = cfg.samples_per_frame
    ov = cfg.istft_overlap
    n_fft = ov * hop
    n_bins = n_fft // 2 + 1

    x = layer_norm(x, params["head_ln_scale"], params["head_ln_bias"])
    h = (
        jnp.dot(x, params["istft_out_w"], preferred_element_type=jnp.float32)
        + params["istft_out_b"].astype(jnp.float32)
    )  # [B, F, 2 * n_bins] f32
    mag = jnp.exp(jnp.clip(h[..., :n_bins], -30.0, 12.0))
    phase = h[..., n_bins:]
    spec = jax.lax.complex(mag * jnp.cos(phase), mag * jnp.sin(phase))

    frames_t = jnp.fft.irfft(spec, n=n_fft, axis=-1)  # [B, F, n_fft] f64->f32
    frames_t = frames_t.astype(jnp.float32)
    # periodic hann synthesis window (torch.hann_window(periodic=True))
    win = 0.5 - 0.5 * jnp.cos(
        2.0 * jnp.pi * jnp.arange(n_fft, dtype=jnp.float32) / n_fft
    )
    frames_t = frames_t * win

    # overlap-add: n_fft = ov * hop exactly, so frame f's window splits into
    # ov hop-sized chunks landing on blocks f..f+ov-1
    fw = frames_t.reshape(B, F, ov, hop)
    acc = None
    for r in range(ov):
        contrib = jnp.pad(fw[:, :, r], ((0, 0), (r, ov - 1 - r), (0, 0)))
        acc = contrib if acc is None else acc + contrib
    blocks = acc[:, :F]  # [B, F, hop] — blocks F..F+ov-2 are future tails

    # window-square-sum normalization (depends only on min(t, ov-1): causal)
    wsq = jnp.square(win).reshape(ov, hop)
    cums = jnp.cumsum(wsq, axis=0)  # cums[t] = sum of chunks 0..t
    if F <= ov - 1:
        wsum = cums[:F]
    else:
        wsum = jnp.concatenate(
            [cums[: ov - 1], jnp.broadcast_to(cums[ov - 1], (F - ov + 1, hop))]
        )
    wsum = jnp.maximum(wsum, 1e-6)  # hann onset ramp (global start only)
    return (blocks / wsum).reshape(B, F * hop)


def vocoder_forward(cfg: VocoderConfig, params: dict, codes: jax.Array) -> jax.Array:
    """codes [B, F, 16] int32 -> audio f32 [B, F * samples_per_frame]."""
    x = embed_codes(cfg, params, codes)  # [B, F, D]

    for blk in params["prenet"]:
        h = causal_dwconv1d(x, blk["dw"])
        h = layer_norm(h, blk["ln_scale"], blk["ln_bias"])
        h = jnp.dot(h, blk["w1"], preferred_element_type=jnp.float32).astype(x.dtype) + blk["b1"]
        h = jax.nn.gelu(h)
        h = jnp.dot(h, blk["w2"], preferred_element_type=jnp.float32).astype(x.dtype) + blk["b2"]
        x = x + h

    if cfg.head == "istft":
        return _istft_head(cfg, params, x)

    for rate, stage in zip(cfg.upsample_rates, params["stages"]):
        B, T, _ = x.shape
        h = causal_conv1d(x, stage["up_w"]) + stage["up_b"]
        cout = h.shape[-1] // rate
        x = h.reshape(B, T * rate, cout)  # sub-pixel upsample (exactly causal)
        x = jax.nn.silu(x)
        for blk, dil in zip(stage["res"], cfg.resblock_dilations):
            r = causal_conv1d(jax.nn.silu(x), blk["w1"], dilation=dil) + blk["b1"]
            r = causal_conv1d(jax.nn.silu(r), blk["w2"]) + blk["b2"]
            x = x + r

    audio = causal_conv1d(x, params["final_w"]) + params["final_b"]
    audio = jnp.tanh(audio.astype(jnp.float32))
    return audio[..., 0]  # [B, F * samples_per_frame]


def vocode_chunk(
    cfg: VocoderConfig,
    params: dict,
    codes_with_context: jax.Array,  # [B, ctx + F, 16]
    context_frames: int,
) -> jax.Array:
    """Streaming vocode: decode [ctx+F] frames, return only the last F frames of
    audio.  Exact (== full decode) when context_frames >= cfg.left_context_frames
    because every conv is causal."""
    audio = vocoder_forward(cfg, params, codes_with_context)
    return audio[:, context_frames * cfg.samples_per_frame :]
