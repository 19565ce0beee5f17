"""Plain float32 reference for the talker, the MTP code predictor and the vocoder.

One straightforward ``jnp`` forward per model with no KV cache, no
quantisation, no kernels and no shared code with the serving path: Qwen3 GQA
attention with QK-norm, RoPE and SwiGLU for the talker and the code
predictor, the per-step MTP heads, and the causal convolution stack of the
vocoder written as explicit sums over kernel taps.  Every contraction runs at
``Precision.HIGHEST`` in float32.

It takes float weights: :func:`dequantize` turns the serving path's int8 and
int4 leaves back into the float values those paths multiply by, so comparing
the two checks the path, not the quantisation error.  ``kv_int8=True`` rounds
each cached K/V vector through the int8 per-(token, head) grid that the int8
KV cache stores, for the same reason.

chip_smoke.py and the tests compare the serving path with these functions.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import CodePredictorConfig, TalkerConfig, TransformerConfig, VocoderConfig

HIGHEST = jax.lax.Precision.HIGHEST


def _mm(eq: str, *xs) -> jax.Array:
    return jnp.einsum(eq, *xs, precision=HIGHEST, preferred_element_type=jnp.float32)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _unpack_nibbles(q: jax.Array) -> jax.Array:
    """[..., K/2, N] int8 bytes -> [..., K, N] int32; row k of the low
    nibbles and row k + K/2 of the high nibbles, each two's complement."""
    b = q.astype(jnp.uint8).astype(jnp.int32)
    lo = ((b & 15) ^ 8) - 8
    hi = (((b >> 4) & 15) ^ 8) - 8
    return jnp.concatenate([lo, hi], axis=-2)


def _dequant_leaf(x):
    from ..ops.quant import QuantizedLinear, QuantizedLinear4

    if isinstance(x, QuantizedLinear):
        return x.q.astype(jnp.float32) * x.scale
    if isinstance(x, QuantizedLinear4):
        w = _unpack_nibbles(x.q).astype(jnp.float32)
        group = w.shape[-2] // x.scale.shape[-2]
        return w * jnp.repeat(x.scale, group, axis=-2)
    return jnp.asarray(x, jnp.float32)


def dequantize(params):
    """Parameter pytree -> the same tree with every weight as float32."""
    from ..ops.quant import QuantizedLinear, QuantizedLinear4

    return jax.tree.map(
        _dequant_leaf, params,
        is_leaf=lambda x: isinstance(x, (QuantizedLinear, QuantizedLinear4)),
    )


# ---------------------------------------------------------------------------
# Transformer (talker and code predictor)
# ---------------------------------------------------------------------------


def _rms(x, w, eps):
    return x * jax.lax.rsqrt(jnp.mean(x * x, axis=-1, keepdims=True) + eps) * w


def _rope(x, pos, theta):
    """x [B, S, N, D], pos [B, S]: rotate-half rotary embedding."""
    half = x.shape[-1] // 2
    inv = theta ** (-jnp.arange(half, dtype=jnp.float32) / half)
    ang = pos.astype(jnp.float32)[..., None] * inv  # [B, S, half]
    c, s = jnp.cos(ang)[:, :, None], jnp.sin(ang)[:, :, None]
    a, b = x[..., :half], x[..., half:]
    return jnp.concatenate([a * c - b * s, b * c + a * s], axis=-1)


def _int8_roundtrip(x):
    """Round each last-axis vector through symmetric int8 with its own
    amax/127 scale (the int8 KV cache's storage grid)."""
    scale = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0, 1e-8)
    return jnp.clip(jnp.round(x / scale), -127, 127) * scale


def _split_layer(cfg: TransformerConfig, p: dict) -> dict:
    """Accept both weight layouts: separate wq/wk/wv/wg/wu, or the serving
    path's concatenated wqkv / wgu."""
    p = dict(p)
    if "wqkv" in p:
        w = p.pop("wqkv")
        p["wq"] = w[..., : cfg.q_dim]
        p["wk"] = w[..., cfg.q_dim : cfg.q_dim + cfg.kv_dim]
        p["wv"] = w[..., cfg.q_dim + cfg.kv_dim :]
    if "wgu" in p:
        w = p.pop("wgu")
        p["wg"] = w[..., : cfg.intermediate_size]
        p["wu"] = w[..., cfg.intermediate_size :]
    return p


def transformer(
    cfg: TransformerConfig,
    params: dict,
    x: jax.Array,  # [B, S, H]
    valid: Optional[jax.Array] = None,  # [B, S] bool: real tokens
    kv_int8: bool = False,
) -> jax.Array:
    """Causal forward over the whole sequence; returns final-norm hidden
    states [B, S, H] in float32.

    Invalid tokens are never attended to and do not advance the RoPE
    position, so a right-padded prompt followed by more tokens sees each
    row's own contiguous positions."""
    x = x.astype(jnp.float32)
    B, S, _ = x.shape
    if valid is None:
        valid = jnp.ones((B, S), bool)
    pos = jnp.cumsum(valid.astype(jnp.int32), axis=1) - 1
    idx = jnp.arange(S)
    mask = (idx[None, :] <= idx[:, None])[None] & valid[:, None, :]  # [B, S, S]
    nq, nk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.rms_norm_eps

    def layer(x, p):
        p = _split_layer(cfg, p)
        h = _rms(x, p["attn_norm"], eps)
        q = _mm("bsh,hn->bsn", h, p["wq"]).reshape(B, S, nq, d)
        k = _mm("bsh,hn->bsn", h, p["wk"]).reshape(B, S, nk, d)
        v = _mm("bsh,hn->bsn", h, p["wv"]).reshape(B, S, nk, d)
        if cfg.use_qk_norm:
            q = _rms(q, p["q_norm"], eps)
            k = _rms(k, p["k_norm"], eps)
        q = _rope(q, pos, cfg.rope_theta)
        k = _rope(k, pos, cfg.rope_theta)
        if kv_int8:
            k, v = _int8_roundtrip(k), _int8_roundtrip(v)
        q = q.reshape(B, S, nk, nq // nk, d)
        scores = _mm("bsgrd,btgd->bgrst", q, k) / jnp.sqrt(jnp.float32(d))
        scores = jnp.where(mask[:, None, None], scores, -1e30)
        w = jax.nn.softmax(scores, axis=-1)
        o = _mm("bgrst,btgd->bsgrd", w, v).reshape(B, S, nq * d)
        x = x + _mm("bsn,nh->bsh", o, p["wo"])
        h = _rms(x, p["mlp_norm"], eps)
        act = jax.nn.silu(_mm("bsh,hi->bsi", h, p["wg"])) * _mm("bsh,hi->bsi", h, p["wu"])
        return x + _mm("bsi,ih->bsh", act, p["wd"]), None

    x, _ = jax.lax.scan(layer, x, params["layers"])
    return _rms(x, params["final_norm"], eps)


def talker_logits(
    cfg: TalkerConfig,
    params: dict,
    embeds: jax.Array,  # [B, S, H] input embeddings
    valid: Optional[jax.Array] = None,
    kv_int8: bool = False,
) -> jax.Array:
    """Codec logits [B, S, V] after every position of ``embeds``."""
    h = transformer(cfg.transformer, params["transformer"], embeds, valid, kv_int8)
    return _mm("bsh,hv->bsv", h, params["lm_head"])


def mtp_logits(
    cfg: CodePredictorConfig,
    params: dict,
    tables: jax.Array,  # [num_steps, subcode_vocab, H] sub-code embeddings
    last_hidden: jax.Array,  # [B, H] talker hidden of this frame
    code0_embed: jax.Array,  # [B, H]
    subcodes: jax.Array,  # [B, num_steps] the frame's sub-codes (teacher)
) -> jax.Array:
    """The 15 sub-code logits [B, num_steps, V] of one frame, teacher-forced.

    Input sequence: [talker hidden, code0 embedding, the embeddings of
    sub-codes 0..n-2]; step j's logits come from position j+1 through head j
    (``per_step``) or the shared head, whose step enters as a learned
    embedding added to that position's input (``shared``)."""
    n = cfg.num_steps
    tables = tables.astype(jnp.float32)
    embs = jnp.stack(
        [jnp.take(tables[j], subcodes[:, j], axis=0) for j in range(n - 1)], axis=1
    )  # [B, n-1, H]
    rest = [code0_embed.astype(jnp.float32)[:, None], embs]
    if cfg.head_mode == "shared":
        se = params["step_embed"].astype(jnp.float32)
        rest = [r + se[i : i + r.shape[1]][None] for r, i in ((rest[0], 0), (rest[1], 1))]
    seq = jnp.concatenate([last_hidden.astype(jnp.float32)[:, None]] + rest, axis=1)
    h = transformer(cfg.transformer, params["transformer"], seq)[:, 1:]  # [B, n, H]
    if cfg.head_mode == "shared":
        return _mm("bnh,hv->bnv", h, params["head"])
    return _mm("bnh,nhv->bnv", h, params["heads"])


# ---------------------------------------------------------------------------
# Vocoder
# ---------------------------------------------------------------------------


def _causal_conv(x, w, dilation=1):
    """x [B, T, Cin], w [K, Cin, Cout]: y[t] = sum_k x[t - (K-1-k)*dil] @ w[k]."""
    K, T = w.shape[0], x.shape[1]
    pad = (K - 1) * dilation
    xp = jnp.pad(x, ((0, 0), (pad, 0), (0, 0)))
    return sum(
        _mm("btc,cd->btd", xp[:, k * dilation : k * dilation + T], w[k])
        for k in range(K)
    )


def _causal_depthwise(x, w):
    """x [B, T, C], w [K, C]: per-channel causal filter."""
    K, T = w.shape[0], x.shape[1]
    xp = jnp.pad(x, ((0, 0), (K - 1, 0), (0, 0)))
    return sum(xp[:, k : k + T] * w[k] for k in range(K))


def _layer_norm(x, scale, bias, eps=1e-6):
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mu), axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * scale + bias


def vocoder(cfg: VocoderConfig, params: dict, codes: jax.Array) -> jax.Array:
    """codes [B, F, 16] -> audio [B, F * samples_per_frame] (conv head)."""
    if cfg.head != "conv":
        raise NotImplementedError(f"reference vocoder covers the conv head, not {cfg.head!r}")
    p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    x = sum(jnp.take(p["codebooks"][i], codes[..., i], axis=0) for i in range(cfg.num_codebooks))
    for blk in p["prenet"]:
        h = _layer_norm(_causal_depthwise(x, blk["dw"]), blk["ln_scale"], blk["ln_bias"])
        h = jax.nn.gelu(_mm("btc,cd->btd", h, blk["w1"]) + blk["b1"])
        x = x + _mm("btc,cd->btd", h, blk["w2"]) + blk["b2"]
    for rate, stage in zip(cfg.upsample_rates, p["stages"]):
        B, T, _ = x.shape
        h = _causal_conv(x, stage["up_w"]) + stage["up_b"]
        x = jax.nn.silu(h.reshape(B, T * rate, h.shape[-1] // rate))
        for blk, dil in zip(stage["res"], cfg.resblock_dilations):
            r = _causal_conv(jax.nn.silu(x), blk["w1"], dil) + blk["b1"]
            x = x + _causal_conv(jax.nn.silu(r), blk["w2"]) + blk["b2"]
    audio = _causal_conv(x, p["final_w"]) + p["final_b"]
    return jnp.tanh(audio)[..., 0]
