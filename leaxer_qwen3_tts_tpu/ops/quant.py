"""Weight-only int8 quantization for the memory-bound decode path.

Single-token decode reads every talker weight (431M params) plus the MTP
stack 15x (92M each) per 12 Hz frame — bound by device-memory bandwidth.
Storing weights as int8 with per-output-channel scales halves the bytes,
provided the dequant (convert + scale) fuses into the matmul's operand read.

Applied as a RUNTIME transform after checkpoint load (checkpoints stay
bf16/f32): `quantize_params(params)` rewrites matmul weights to
``QuantizedLinear``; the model code calls :func:`dense`, which dispatches on
leaf type.  Training and TP-sharded paths use unquantized params (the
sharding rules key on raw array paths).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import jax
import jax.numpy as jnp


class QuantizedLinear(NamedTuple):
    """int8 weight + per-output-channel scale.

    q:     int8, [..., in, out] (leading axes = layer stack)
    scale: float32, [..., 1, out]
    """

    q: jax.Array
    scale: jax.Array


INT4_GROUP = 128  # K-rows per int4 scale group


class QuantizedLinear4(NamedTuple):
    """int4 weight (two nibbles per byte) + per-(K-group, out-column) scales.

    q:     int8, [..., in/2, out] — byte at row k packs weight rows k (LOW
           nibble) and k + in/2 (HIGH nibble), both two's-complement in
           [-8, 7].  The half-split packing means unpacking is two shift ops
           and the matmul splits into x[:, :K/2] @ lo + x[:, K/2:] @ hi — no
           interleave.
    scale: float32, [..., in/INT4_GROUP, out] — group g covers input rows
           [g*INT4_GROUP, (g+1)*INT4_GROUP).  int4's coarse grid needs
           group-wise scales (per-column-only int4 loses ~2 bits of dynamic
           range across a 1024-row column).
    """

    q: jax.Array
    scale: jax.Array


WeightLike = Union[jax.Array, QuantizedLinear, QuantizedLinear4]


def quantize_weight(w: jax.Array) -> QuantizedLinear:
    """Per-output-channel symmetric int8 quantization over the 'in' axis."""
    wf = jnp.asarray(w, jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=-2, keepdims=True)  # [..., 1, out]
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    q = jnp.clip(jnp.round(wf / scale), -127, 127).astype(jnp.int8)
    return QuantizedLinear(q=q, scale=scale.astype(jnp.float32))


def quantize_weight_int4(w: jax.Array, group: int = INT4_GROUP) -> QuantizedLinear4:
    """Symmetric int4 quantization with per-(K-group, out-column) scales.

    """
    import math

    wf = jnp.asarray(w, jnp.float32)
    K, N = wf.shape[-2], wf.shape[-1]
    if K % 2 != 0:
        raise ValueError(f"int4 packing needs an even K, got {K}")
    # shrink the group to a divisor of K/2 (small/odd-shaped models) so any
    # even K quantizes instead of hard-failing (round-2 advisor finding)
    group = math.gcd(min(group, max(K // 2, 1)), K // 2)
    lead = wf.shape[:-2]
    g = wf.reshape(*lead, K // group, group, N)
    amax = jnp.max(jnp.abs(g), axis=-2, keepdims=True)  # [..., G, 1, N]
    scale = jnp.where(amax > 0, amax / 7.0, 1.0)
    q = jnp.clip(jnp.round(g / scale), -8, 7).astype(jnp.int32)
    q = q.reshape(*lead, K, N)
    lo, hi = q[..., : K // 2, :], q[..., K // 2 :, :]
    packed = ((hi & 0xF) << 4) | (lo & 0xF)  # [..., K/2, N] in [0, 255]
    packed = jax.lax.bitcast_convert_type(packed.astype(jnp.uint8), jnp.int8)
    return QuantizedLinear4(
        q=packed, scale=scale.reshape(*lead, K // group, N).astype(jnp.float32)
    )


def unpack_int4(q: jax.Array) -> jax.Array:
    """[..., K/2, N] packed bytes -> [..., K, N] int32 values in [-8, 7]."""
    b = q.astype(jnp.int32)
    lo = (b << 28) >> 28  # sign-extended low nibble
    hi = b >> 4  # arithmetic shift: sign-extended high nibble
    return jnp.concatenate([lo, hi], axis=-2)


def _dense4(x: jax.Array, w: QuantizedLinear4) -> jax.Array:
    """Group-scaled int4 matmul: per-group bf16 dots with f32 accumulation,
    scales applied post-dot in f32."""
    assert w.q.ndim == 2, "int4 dense expects an unstacked [K/2, N] weight"
    K2, N = w.q.shape
    K = 2 * K2
    G = w.scale.shape[-2]
    gs = K // G
    wfull = unpack_int4(w.q).astype(jnp.bfloat16)  # [K, N]
    # lhs keeps its dtype (f32 x bf16 dot, like the int8 path): CPU XLA's
    # thunks reject BF16xBF16=F32, and the lhs is tiny anyway
    xg = x.reshape(*x.shape[:-1], G, gs)
    part = jnp.einsum(
        "...gk,gkn->...gn",
        xg,
        wfull.reshape(G, gs, N),
        preferred_element_type=jnp.float32,
    )  # [..., G, N]
    return jnp.sum(part * w.scale, axis=-2)


def dense(x: jax.Array, w: WeightLike) -> jax.Array:
    """x [..., in] @ w -> [..., out] with float32 accumulation.

    QuantizedLinear path: the int8 tensor converts to bf16 in-graph; the
    intent is that XLA fuses the convert into the dot's operand stream so
    device-memory traffic is the int8 bytes (whether the GPU compiler does
    so at every shape is an open question, PERF.md).
    """
    if isinstance(w, QuantizedLinear4):
        return _dense4(x, w)
    if isinstance(w, QuantizedLinear):
        y = jnp.dot(
            x, w.q.astype(jnp.bfloat16), preferred_element_type=jnp.float32
        )
        return y * w.scale.reshape(w.scale.shape[-1])
    return jnp.dot(x, w, preferred_element_type=jnp.float32)


def weight_dtype(w: WeightLike):
    return (
        jnp.bfloat16
        if isinstance(w, (QuantizedLinear, QuantizedLinear4))
        else w.dtype
    )


def index_weight(w: WeightLike, i, axis: int = 0) -> WeightLike:
    """dynamic_index_in_dim through a possibly-quantized stacked weight."""
    if isinstance(w, (QuantizedLinear, QuantizedLinear4)):
        return type(w)(
            q=jax.lax.dynamic_index_in_dim(w.q, i, axis=axis, keepdims=False),
            scale=jax.lax.dynamic_index_in_dim(w.scale, i, axis=axis, keepdims=False),
        )
    return jax.lax.dynamic_index_in_dim(w, i, axis=axis, keepdims=False)


# weight names (leaf keys) that are matmul operands and safe to quantize
_MATMUL_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "wg", "wu", "wd", "lm_head", "heads",
     "head", "wqkv", "wgu"}
)


def fuse_params(params, modules: Sequence[str] = ("talker", "code_predictor")):
    """Concatenate per-layer (wq,wk,wv) -> wqkv and (wg,wu) -> wgu.

    One [H, q+2kv] matvec instead of three and one [H, 2I] instead of two:
    fewer op dispatches and denser HBM streams on the decode path.  Inference
    transform only — training and TP sharding keep the separate layout
    (models/layers.py dispatches on key presence)."""

    def fuse_layers(layers: dict) -> dict:
        out = {k: v for k, v in layers.items()}
        if all(k in out for k in ("wq", "wk", "wv")):
            out["wqkv"] = jnp.concatenate(
                [out.pop("wq"), out.pop("wk"), out.pop("wv")], axis=-1
            )
        if all(k in out for k in ("wg", "wu")):
            out["wgu"] = jnp.concatenate([out.pop("wg"), out.pop("wu")], axis=-1)
        return out

    out = {}
    for key, sub in params.items():
        if key in modules and isinstance(sub, dict) and "transformer" in sub:
            tr = dict(sub["transformer"])
            tr["layers"] = fuse_layers(tr["layers"])
            out[key] = {**sub, "transformer": tr}
        else:
            out[key] = sub
    return out


# in int4 mode these keys stay int8: lm_head/heads feed the sampler directly
# (logit fidelity is the quality-critical surface)
_INT8_ONLY_KEYS = frozenset({"lm_head", "heads", "head"})


def quantize_params(
    params,
    modules: Sequence[str] = ("talker", "code_predictor"),
    bits: int = 8,
):
    """Quantize the matmul weights of the given top-level modules.

    Embedding gather tables, norms, the vocoder, and the speaker encoder stay
    in their original dtype (gathers don't dequant-fuse; the rest is cheap).
    ``bits=4`` applies group-128 int4 to the transformer matmuls and keeps
    the output heads (lm_head / MTP heads) int8.
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def quant_one(k, v):
        # odd-K matmuls can't nibble-pack; degrade to int8 rather than fail
        if bits == 4 and k not in _INT8_ONLY_KEYS and v.shape[-2] % 2 == 0:
            return quantize_weight_int4(v)
        return quantize_weight(v)

    def walk(node, quantizing: bool):
        if isinstance(node, dict):
            return {
                k: (
                    quant_one(k, v)
                    if quantizing and k in _MATMUL_KEYS and hasattr(v, "ndim")
                    else walk(v, quantizing)
                )
                for k, v in node.items()
            }
        if hasattr(node, "_fields"):  # NamedTuple (QuantizedLinear, ...):
            return node  # already quantized, pass through
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, quantizing) for v in node)
        return node

    out = {}
    for key, sub in params.items():
        out[key] = walk(sub, quantizing=key in modules)
    return out
