"""On-device sampling: temperature / top-k / top-p with explicit PRNG keys.

Semantics mirror the reference sampler (tts_onnx.cpp:878-950): temperature
scaling, top-k threshold filter, softmax, top-p nucleus cutoff that KEEPS the
first token crossing the cumulative bound — but run entirely on device with
``jax.random`` key threading, which adds the determinism the reference lacks
(its ``std::mt19937`` is seeded from ``random_device`` with no seed flag,
tts_onnx.cpp:901-902).

All sampling parameters are traced values, so one compiled generate function
serves every temperature / top-k / top-p setting without recompilation.
temperature == 0 selects greedy argmax decoding (fixture-testable).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import CODEC_EOS, DEFAULT_TEMPERATURE, DEFAULT_TOP_K, DEFAULT_TOP_P

NEG_INF = -1e30


def split_keys(key: jax.Array, n: int):
    """Split a scalar PRNG key [2] — or per-row keys [B, 2] — into n keys.

    Returns a tuple of n arrays shaped like ``key``.  Per-row keys give each
    batch row its OWN threefry chain: a row's draws depend only on its key
    and its split depth, never on batch-mates — the occupancy-invariance the
    continuous pool's per-request determinism needs (serve/pool.py)."""
    if key.ndim == 2:
        ks = jax.vmap(lambda kk: jax.random.split(kk, n))(key)  # [B, n, 2]
        return tuple(ks[:, i] for i in range(n))
    ks = jax.random.split(key, n)
    return tuple(ks[i] for i in range(n))


def _categorical(key: jax.Array, scaled: jax.Array) -> jax.Array:
    """jax.random.categorical, accepting per-row keys [B, 2] for [B, V]
    logits (each row draws from its own stream)."""
    if key.ndim == 2 and scaled.ndim == 2:
        return jax.vmap(jax.random.categorical)(key, scaled)
    return jax.random.categorical(key, scaled, axis=-1)


class SamplingParams(NamedTuple):
    """Device-side sampling knobs, traced.  Each field is a scalar or a [B]
    vector (per-request knobs inside one serving batch)."""

    temperature: jax.Array
    top_k: jax.Array  # int32; <= 0 disables
    top_p: jax.Array  # float; >= 1.0 disables
    forbid_eos: jax.Array  # bool; True masks CODEC_EOS (min-length / benchmarking)

    @classmethod
    def create(
        cls,
        temperature: float = DEFAULT_TEMPERATURE,
        top_k: int = DEFAULT_TOP_K,
        top_p: float = DEFAULT_TOP_P,
        forbid_eos: bool = False,
    ) -> "SamplingParams":
        """Scalars or per-request sequences (all non-scalars must be length B)."""
        return cls(
            temperature=jnp.asarray(temperature, jnp.float32),
            top_k=jnp.asarray(top_k, jnp.int32),
            top_p=jnp.asarray(top_p, jnp.float32),
            forbid_eos=jnp.asarray(forbid_eos, bool),
        )


def _per_row(p: jax.Array) -> jax.Array:
    """[B] knob -> [B, 1] for broadcasting against [B, V] logits."""
    return p[..., None] if p.ndim > 0 else p


def _top_k_mask(logits: jax.Array, k: jax.Array) -> jax.Array:
    """Mask logits strictly below the k-th largest value (reference keeps ties,
    tts_onnx.cpp:917-927: filters x < threshold).  k: scalar or [B, 1]."""
    V = logits.shape[-1]
    sorted_desc = jnp.sort(logits, axis=-1)[..., ::-1]
    k_idx = jnp.broadcast_to(
        jnp.clip(k - 1, 0, V - 1), logits.shape[:-1] + (1,)
    ).astype(jnp.int32)
    threshold = jnp.take_along_axis(sorted_desc, k_idx, axis=-1)
    keep = logits >= threshold
    active = (k > 0) & (k < V)
    return jnp.where(active, keep, True)


def _top_p_mask(logits: jax.Array, p: jax.Array) -> jax.Array:
    """Nucleus mask over softmax probs: keep tokens whose exclusive cumulative
    probability (in descending order) is < p — i.e. including the first token
    that crosses p, matching the reference cutoff (tts_onnx.cpp:929-950)."""
    probs = jax.nn.softmax(logits, axis=-1)
    order = jnp.argsort(-probs, axis=-1)
    sorted_probs = jnp.take_along_axis(probs, order, axis=-1)
    cum_excl = jnp.cumsum(sorted_probs, axis=-1) - sorted_probs
    keep_sorted = cum_excl < p
    keep = jnp.zeros_like(keep_sorted)
    keep = jnp.put_along_axis(keep, order, keep_sorted, axis=-1, inplace=False)
    return jnp.where(p >= 1.0, True, keep)


K_CAP = 128  # static top-k subset width for the fast sampling path


def _sample_full(key, logits, params):
    """Exact full-vocab path (sort-based): used when top_k is disabled or
    exceeds K_CAP.  O(V log V) sorts — slower, rare in practice."""
    t = _per_row(jnp.maximum(params.temperature, 1e-6))
    scaled = logits / t
    scaled = jnp.where(_top_k_mask(scaled, _per_row(params.top_k)), scaled, NEG_INF)
    scaled = jnp.where(_top_p_mask(scaled, _per_row(params.top_p)), scaled, NEG_INF)
    return _categorical(key, scaled).astype(jnp.int32)


def _sample_topk_subset(key, logits, params):
    """Fast path: restrict to the top-K_CAP logits once (lax.top_k), then do
    temperature / top-k / top-p inside the already-sorted subset.

    Equivalent to the full path whenever top_k <= K_CAP: the top-k filter
    leaves a subset of the top-K_CAP entries, and the top-p cutoff operates on
    the softmax of the filtered set, which is unchanged by dropping the
    never-eligible tail.  ~100x less sort work per sample than full-vocab
    sorting (the reference sorts the whole vocab per token on the host,
    tts_onnx.cpp:917-950)."""
    V = logits.shape[-1]
    k_cap = min(K_CAP, V)
    vals, idx = jax.lax.top_k(logits, k_cap)  # sorted desc [..., k_cap]
    pos = jnp.arange(k_cap)
    shape = (1,) * (logits.ndim - 1) + (k_cap,)
    pos = pos.reshape(shape)

    # top-k: threshold cut inside the sorted subset — keep vals >= the k-th
    # value so ties straddling the cutoff survive, exactly like _top_k_mask
    # and the reference filter (tts_onnx.cpp:917-927)
    top_k = _per_row(params.top_k)
    k_idx = jnp.broadcast_to(
        jnp.clip(top_k - 1, 0, k_cap - 1), vals.shape[:-1] + (1,)
    ).astype(jnp.int32)
    threshold = jnp.take_along_axis(vals, k_idx, axis=-1)
    keep = jnp.where(top_k > 0, vals >= threshold, True)
    t = _per_row(jnp.maximum(params.temperature, 1e-6))
    scaled = jnp.where(keep, vals / t, NEG_INF)

    # top-p on the sorted, filtered subset; always keep the best token
    probs = jax.nn.softmax(scaled, axis=-1)
    cum_excl = jnp.cumsum(probs, axis=-1) - probs
    keep_p = (cum_excl < _per_row(params.top_p)) | (pos == 0)
    scaled = jnp.where(keep_p, scaled, NEG_INF)

    choice = _categorical(key, scaled)  # [...]
    return jnp.take_along_axis(idx, choice[..., None], axis=-1)[..., 0].astype(
        jnp.int32
    )


def sample_token(
    key: jax.Array,
    logits: jax.Array,  # [..., V] float32
    params: SamplingParams,
) -> jax.Array:
    """Sample token ids [...] int32.  temperature == 0 -> greedy argmax.

    ``key`` may be a scalar key [2] (one stream for the batch — the offline
    paths) or per-row keys [B, 2] for [B, V] logits (each row samples from
    its own chain — pool slots / per-request seeds)."""
    greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)

    V = logits.shape[-1]
    if V <= K_CAP:
        sampled = _sample_full(key, logits, params)
    else:
        # per-request knobs: take the fast path only if EVERY row qualifies
        use_fast = jnp.all((params.top_k > 0) & (params.top_k <= K_CAP))
        sampled = jax.lax.cond(
            use_fast, _sample_topk_subset, _sample_full, key, logits, params
        )

    return jnp.where(params.temperature <= 0.0, greedy, sampled)


def make_codec_suppress_mask(vocab_size: int = 3072) -> jax.Array:
    """Additive mask suppressing codec control tokens 2048..vocab-1 except
    CODEC_EOS (reference tts_onnx.cpp:802-807)."""
    ids = jnp.arange(vocab_size)
    suppress = (ids >= 2048) & (ids != CODEC_EOS)
    return jnp.where(suppress, NEG_INF, 0.0).astype(jnp.float32)
