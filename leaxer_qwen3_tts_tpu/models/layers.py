"""Core transformer building blocks (functional JAX, parameter pytrees).

One unified code path serves prefill and decode: every forward writes the new
K/V into a static, device-resident cache at ``cache_len`` and attends over the
whole (masked) cache.  This deletes the reference's per-step host<->device KV
round-trips (reference tts_onnx.cpp:684-729 copies 28 layers of KV both ways on
every decode step); here the cache never leaves device memory and the update is a
``lax.dynamic_update_slice`` inside the jitted step.

Layer stack is scanned (``lax.scan`` over stacked per-layer params) so 28 layers
compile as one loop — fast compiles, identical runtime code for every layer.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import TransformerConfig
from ..ops.attention import attend_xla
from ..ops.quant import dense


class KVCache(NamedTuple):
    """Static per-model KV cache, HEAD-MAJOR layout.

    k, v: [num_layers, batch, num_kv_heads, max_len, head_dim]
    length: [batch] int32 — filled slots PER SEQUENCE (continuous serving
        admits streams mid-flight, so fill levels diverge; a separate validity
        mask marks right-padded prompt slots as unattendable).
    k_scale, v_scale: None (bf16/f32 cache) or float32
        [num_layers, batch, num_kv_heads, max_len] — per-slot-per-head
        symmetric int8 scales (``cfg.kv_cache_quant``).  Per-slot scales track
        magnitude drift over the sequence (a single per-head scale loses
        ~2 bits once early loud frames pin the range); the dequant applies to
        the score/weight matrices, never to the cache itself, so HBM traffic
        is the int8 bytes.

    Head-major (heads before time) makes the decode-step attention a clean
    batched [g, d] x [d, T] GEMM with no cache transposes; a time-major
    layout would relayout the whole cache every step.
    """

    k: jax.Array
    v: jax.Array
    length: jax.Array  # [batch] int32
    k_scale: Optional[jax.Array] = None  # f32 [L, B, Nk, T] when k is int8
    v_scale: Optional[jax.Array] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int) -> KVCache:
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if cfg.kv_cache_quant:
        sshape = shape[:-1]
        return KVCache(
            k=jnp.zeros(shape, jnp.int8),
            v=jnp.zeros(shape, jnp.int8),
            length=jnp.zeros((batch,), jnp.int32),
            k_scale=jnp.zeros(sshape, jnp.float32),
            v_scale=jnp.zeros(sshape, jnp.float32),
        )
    dtype = cfg.jnp_dtype
    return KVCache(
        k=jnp.zeros(shape, dtype),
        v=jnp.zeros(shape, dtype),
        length=jnp.zeros((batch,), jnp.int32),
    )


def splice_kv_cache(cache: KVCache, c1: KVCache, slot) -> KVCache:
    """Write a 1-stream cache ``c1`` into batch row ``slot`` of ``cache``
    (continuous-pool admission).  Handles quantized caches (scale arrays
    splice alongside) so callers never touch the field list."""
    dus = lax.dynamic_update_slice
    out = cache._replace(
        k=dus(cache.k, c1.k, (0, slot, 0, 0, 0)),
        v=dus(cache.v, c1.v, (0, slot, 0, 0, 0)),
        length=dus(cache.length, c1.length, (slot,)),
    )
    if cache.k_scale is not None:
        out = out._replace(
            k_scale=dus(cache.k_scale, c1.k_scale, (0, slot, 0, 0)),
            v_scale=dus(cache.v_scale, c1.v_scale, (0, slot, 0, 0)),
        )
    return out


def quantize_kv(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """[..., d] float -> (int8 [..., d], f32 scale [...]) per-vector symmetric.

    f32 math, jnp.round, amax/127 scale floored at 1e-8."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1)
    scale = jnp.maximum(amax / 127.0, 1e-8)
    q = jnp.clip(jnp.round(xf / scale[..., None]), -127, 127).astype(jnp.int8)
    return q, scale


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------


def rms_norm(x: jax.Array, weight: jax.Array, eps: float) -> jax.Array:
    """RMSNorm in float32, result cast back to input dtype (Qwen3 style)."""
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    var = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
    normed = xf * lax.rsqrt(var + eps)
    return (normed * weight.astype(jnp.float32)).astype(dtype)


def rope_angles(positions: jax.Array, head_dim: int, theta: float) -> Tuple[jax.Array, jax.Array]:
    """cos/sin tables for rotary embedding.  positions: [...]; returns [..., head_dim/2]."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (jnp.arange(half, dtype=jnp.float32) / half))
    angles = positions.astype(jnp.float32)[..., None] * freqs
    return jnp.cos(angles), jnp.sin(angles)


def apply_rope(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """Rotary embedding, rotate-half (GPT-NeoX / Qwen) convention.

    x: [B, S, N, D]; cos/sin: [B, S, D/2] broadcast over heads.
    """
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    rotated = jnp.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], axis=-1)
    return rotated.astype(dtype)


def swiglu(x: jax.Array, wg, wu, wd) -> jax.Array:
    gate = jax.nn.silu(dense(x, wg))
    up = dense(x, wu)
    return dense((gate * up).astype(x.dtype), wd).astype(x.dtype)


def _qkv(cfg: TransformerConfig, p: dict, h: jax.Array, dtype):
    """q/k/v projections; uses the fused wqkv weight when present
    (ops/quant.fuse_params inference layout)."""
    if "wqkv" in p:
        qkv = dense(h, p["wqkv"]).astype(dtype)
        q = qkv[..., : cfg.q_dim]
        k = qkv[..., cfg.q_dim : cfg.q_dim + cfg.kv_dim]
        v = qkv[..., cfg.q_dim + cfg.kv_dim :]
        return q, k, v
    return (
        dense(h, p["wq"]).astype(dtype),
        dense(h, p["wk"]).astype(dtype),
        dense(h, p["wv"]).astype(dtype),
    )


def _mlp(cfg: TransformerConfig, p: dict, h: jax.Array) -> jax.Array:
    """SwiGLU MLP; uses the fused wgu weight when present."""
    if "wgu" in p:
        gu = dense(h, p["wgu"])
        gate, up = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size :]
        act = (jax.nn.silu(gate) * up).astype(h.dtype)
        return dense(act, p["wd"]).astype(h.dtype)
    return swiglu(h, p["wg"], p["wu"], p["wd"])


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def _dense_init(key, fan_in, shape, dtype):
    scale = 1.0 / jnp.sqrt(fan_in)
    return (jax.random.normal(key, shape, jnp.float32) * scale).astype(dtype)


def init_layer_params(cfg: TransformerConfig, key: jax.Array) -> dict:
    """Params for ONE transformer block (leaves unstacked)."""
    h, qd, kvd = cfg.hidden_size, cfg.q_dim, cfg.kv_dim
    dt = cfg.jnp_dtype
    ks = jax.random.split(key, 8)
    p = {
        "attn_norm": jnp.ones((h,), dt),
        "wq": _dense_init(ks[0], h, (h, qd), dt),
        "wk": _dense_init(ks[1], h, (h, kvd), dt),
        "wv": _dense_init(ks[2], h, (h, kvd), dt),
        "wo": _dense_init(ks[3], qd, (qd, h), dt),
        "mlp_norm": jnp.ones((h,), dt),
        "wg": _dense_init(ks[4], h, (h, cfg.intermediate_size), dt),
        "wu": _dense_init(ks[5], h, (h, cfg.intermediate_size), dt),
        "wd": _dense_init(ks[6], cfg.intermediate_size, (cfg.intermediate_size, h), dt),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = jnp.ones((cfg.head_dim,), dt)
        p["k_norm"] = jnp.ones((cfg.head_dim,), dt)
    return p


def init_transformer_params(cfg: TransformerConfig, key: jax.Array) -> dict:
    """Stacked-layer params: every leaf has a leading [num_layers] axis."""
    keys = jax.random.split(key, cfg.num_layers + 1)
    layers = [init_layer_params(cfg, k) for k in keys[: cfg.num_layers]]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *layers)
    return {
        "layers": stacked,
        "final_norm": jnp.ones((cfg.hidden_size,), cfg.jnp_dtype),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _block(
    cfg: TransformerConfig,
    p: dict,
    x: jax.Array,  # [B, S, H]
    cos: jax.Array,
    sin: jax.Array,
    k_cache: jax.Array,  # [B, Nk, T, D] head-major (int8 when quantized)
    v_cache: jax.Array,
    ks_cache: Optional[jax.Array],  # f32 [B, Nk, T] int8 scales (or None)
    vs_cache: Optional[jax.Array],
    cache_len: jax.Array,  # [B] int32 — per-sequence write offset
    attn_mask: jax.Array,  # [B, S, T] bool
):
    B, S, H = x.shape
    nq, nk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv(cfg, p, h, x.dtype)
    q = q.reshape(B, S, nq, d)
    k = k.reshape(B, S, nk, d)
    v = v.reshape(B, S, nk, d)

    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps)

    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if ks_cache is not None:
        # int8 cache: quantize the post-RoPE K/V per (token, head) — the
        # cached value IS the dequantized one everywhere downstream
        k, k_sc = quantize_kv(k)  # k int8 [B,S,nk,d], k_sc f32 [B,S,nk]
        v, v_sc = quantize_kv(v)

    # Write this step's K/V into the head-major cache.  The new [B,S,Nk,D]
    # slab transposes once — S*Nk*D elements, trivial — so the big cache is
    # never relayouted.  Uniform fill (scalar cache_len: every sequence at
    # the same slot — the engine/serving-batch path) lowers to ONE contiguous
    # dynamic_update_slice that updates S slots in place; per-sequence fills
    # (continuous pool) need the vmapped scatter, which is why the uniform
    # path is kept separate (the scatter costs whole-cache traffic at B>1).
    if cache_len.ndim == 0:
        k_cache = lax.dynamic_update_slice(
            k_cache, jnp.swapaxes(k, 1, 2), (0, 0, cache_len, 0)
        )
        v_cache = lax.dynamic_update_slice(
            v_cache, jnp.swapaxes(v, 1, 2), (0, 0, cache_len, 0)
        )
        if ks_cache is not None:
            ks_cache = lax.dynamic_update_slice(
                ks_cache, jnp.swapaxes(k_sc, 1, 2), (0, 0, cache_len)
            )
            vs_cache = lax.dynamic_update_slice(
                vs_cache, jnp.swapaxes(v_sc, 1, 2), (0, 0, cache_len)
            )
    else:
        write = jax.vmap(
            lambda c, new, off: lax.dynamic_update_slice(c, new, (0, off, 0))
        )
        k_cache = write(k_cache, jnp.swapaxes(k, 1, 2), cache_len)
        v_cache = write(v_cache, jnp.swapaxes(v, 1, 2), cache_len)
        if ks_cache is not None:
            write_s = jax.vmap(
                lambda c, new, off: lax.dynamic_update_slice(c, new, (0, off))
            )
            ks_cache = write_s(ks_cache, jnp.swapaxes(k_sc, 1, 2), cache_len)
            vs_cache = write_s(vs_cache, jnp.swapaxes(v_sc, 1, 2), cache_len)

    out = attend_xla(
        q, k_cache, v_cache, attn_mask, k_scale=ks_cache, v_scale=vs_cache
    )  # [B,S,Nq,D]
    out = out.reshape(B, S, nq * d)
    x = x + dense(out, p["wo"]).astype(x.dtype)

    h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    x = x + _mlp(cfg, p, h)
    return x, k_cache, v_cache, ks_cache, vs_cache


def transformer_forward(
    cfg: TransformerConfig,
    params: dict,
    embeds: jax.Array,  # [B, S, H]
    positions: jax.Array,  # [B, S] int32 — RoPE positions per sequence
    cache: KVCache,
    valid_mask: jax.Array,  # [B, T] bool — cache slots that hold real tokens
    query_valid: Optional[jax.Array] = None,  # [B, S] bool — real (non-pad) queries
    uniform_fill: bool = True,
) -> Tuple[jax.Array, KVCache, jax.Array]:
    """Unified prefill/decode forward.

    Writes S new tokens at cache slots [length[b], length[b]+S) and lets
    query i attend to cache slot t iff ``valid_mask[b, t]`` and
    t <= length[b]+i (causal over write order).  Lengths are per-sequence so
    continuous serving can run streams at different fill levels in one batch;
    ``uniform_fill=True`` (the default — engine and serving-batch paths,
    where every stream fills in lockstep) keeps the cheap single
    dynamic_update_slice cache write instead of the batched scatter.
    Returns post-final-norm hidden states [B, S, H], the updated cache
    (lengths advanced by S), and the updated validity mask.
    """
    B, S, H = embeds.shape
    T = cache.max_len
    length = cache.length  # [B]
    len_col = length[0:1, None] if uniform_fill else length[:, None]  # [1|B, 1]

    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    # Mark newly-written slots valid (pad queries stay invalid).
    slot_ids = jnp.arange(T, dtype=jnp.int32)
    if query_valid is None:
        query_valid = jnp.ones((B, S), bool)
    new_slots = (slot_ids[None, :] >= len_col) & (
        slot_ids[None, :] < len_col + S
    )  # [1|B, T]
    # scatter query_valid into the new slot range
    write_idx = jnp.clip(slot_ids[None, :] - len_col, 0, S - 1)  # [1|B, T]
    written_valid = jnp.take_along_axis(
        query_valid, jnp.broadcast_to(write_idx, (B, T)), axis=1
    )
    valid_mask = jnp.where(new_slots, written_valid, valid_mask)

    # attention mask [B, S, T]: causal over global write order + validity
    global_q = len_col + jnp.arange(S, dtype=jnp.int32)[None, :]  # [1|B, S]
    causal = slot_ids[None, None, :] <= global_q[:, :, None]  # [1|B, S, T]
    attn_mask = causal & valid_mask[:, None, :]

    x = embeds

    cache_len = length[0] if uniform_fill else length

    def body(x, layer):
        p, kc, vc, ksc, vsc = layer
        x, kc, vc, ksc, vsc = _block(
            cfg, p, x, cos, sin, kc, vc, ksc, vsc, cache_len, attn_mask
        )
        return x, (kc, vc, ksc, vsc)

    # None scale leaves flatten away, so the unquantized scan is unchanged
    x, (new_k, new_v, new_ks, new_vs) = lax.scan(
        body, x,
        (params["layers"], cache.k, cache.v, cache.k_scale, cache.v_scale),
    )
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)

    new_cache = KVCache(
        k=new_k, v=new_v, length=length + S, k_scale=new_ks, v_scale=new_vs
    )
    return x, new_cache, valid_mask


def transformer_forward_nocache(
    cfg: TransformerConfig,
    params: dict,
    embeds: jax.Array,  # [B, S, H]
    positions: Optional[jax.Array] = None,
    valid: Optional[jax.Array] = None,  # [B, S] bool
) -> jax.Array:
    """Plain causal forward without a cache (training / scoring path)."""
    B, S, H = embeds.shape
    if positions is None:
        positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    ids = jnp.arange(S, dtype=jnp.int32)
    attn_mask = ids[None, None, :] <= ids[None, :, None]  # [1, S, S] causal
    attn_mask = jnp.broadcast_to(attn_mask, (B, S, S))
    if valid is not None:
        attn_mask = attn_mask & valid[:, None, :]

    zero_len = jnp.zeros((), jnp.int32)

    def body(x, layer_p):
        h = rms_norm(x, layer_p["attn_norm"], cfg.rms_norm_eps)
        nq, nk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q, k, v = _qkv(cfg, layer_p, h, x.dtype)
        q = q.reshape(B, S, nq, d)
        k = k.reshape(B, S, nk, d)
        v = v.reshape(B, S, nk, d)
        if cfg.use_qk_norm:
            q = rms_norm(q, layer_p["q_norm"], cfg.rms_norm_eps)
            k = rms_norm(k, layer_p["k_norm"], cfg.rms_norm_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out = attend_xla(
            q, jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2), attn_mask
        )
        out = out.reshape(B, S, nq * d)
        x = x + dense(out, layer_p["wo"]).astype(x.dtype)
        h = rms_norm(x, layer_p["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp(cfg, layer_p, h)
        return x, None

    x, _ = lax.scan(body, embeds, params["layers"])
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
