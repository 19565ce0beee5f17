"""Continuous batching: a persistent SPMD decode pool with per-slot admit/retire.

The static batcher (server.py) forms a batch, runs it to completion, and only
then admits new work — a long utterance holds its batch-mates hostage and a
language change head-of-line-blocks the queue.  This pool fixes both:

  * B decode SLOTS run one shared chunked-decode program forever; requests are
    ADMITTED into free slots at chunk boundaries and RETIRED independently on
    EOS or their own max_tokens.  A short request admitted mid-flight
    finishes without waiting for a long batch-mate.
  * language / speaker-style conditioning lives entirely in the per-request
    PREFILL (batch-1, its own jit signature); the pool decode program is
    signature-uniform, so mixed languages coexist in one batch — no
    head-of-line blocking on jit signatures.
  * per-request sampling knobs ride as [B] vectors (runtime/sampling.py) and
    are updated host-side on admission.

Mechanics: admission runs a batch-1 prefill sized to the pool's KV bucket,
then SPLICES the resulting single-stream state into slot b of the pool state
(per-slot ``pos`` / ``step`` / text-drip buffers — GenerateState carries all
of these as [B] vectors).  Retirement vocodes the stream's own codes (length
bucketed) and resolves its future.

Determinism: the pool state carries PER-SLOT PRNG keys ([B, 2] — see
runtime/sampling.split_keys), seeded at admission from (pool seed, request
seed) and advanced one split per frame per slot, so a request's sampled
output is a pure function of (text, language, knobs, seed) — identical
regardless of which slot it lands in or what else is in flight.  Requests
without an explicit seed draw a fresh chain per admission.

The reference has no serving layer at all (SURVEY §2.3: one process, one
request, batch fixed at 1 — tts_onnx.cpp:547,618,672,760).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..api.engine import (
    EngineError,
    SynthesisResult,
    TTSEngine,
    _round_up,
)
from ..config import SAMPLE_RATE, language_to_codec_id
from ..models.codec12hz import vocoder_forward
from ..models.talker import talker_init_cache
from ..runtime.generate import GenerateState, make_generate_fns
from ..runtime.prompt import prompt_length
from ..runtime.sampling import SamplingParams
from ..utils.logging import get_logger
from ..utils.metrics import SynthesisMetrics

log = get_logger(__name__)




_STREAM_DONE = object()  # chunk-queue sentinel: no more audio chunks


@dataclass
class _PoolRequest:
    text: str
    language: str
    temperature: float
    top_k: int
    top_p: float
    max_tokens: Optional[int]
    forbid_eos: bool = False  # benchmarking / length-forcing knob
    seed: Optional[int] = None  # per-request determinism (occupancy-invariant)
    # streaming requests receive incremental audio chunks on chunk_q while
    # still decoding in the SHARED pool batch (per-slot incremental vocode)
    stream: bool = False
    chunk_q: Optional["queue.Queue"] = None
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.perf_counter)


@dataclass
class _Active:
    req: _PoolRequest
    budget: int
    frames: List[np.ndarray] = field(default_factory=list)  # [16] rows
    admitted_at: float = field(default_factory=time.perf_counter)
    # --- streaming emitter state (stream=True requests only) ---
    # committed frames vocode incrementally with a rolling causal left
    # context (exactly the engine B=1 scheme, api/engine.py streaming loop);
    # the retired result's audio IS the concatenation of the emitted chunks,
    # so streamed and final audio are bit-identical by construction.
    emit_lock: threading.Lock = field(default_factory=threading.Lock)
    emit_busy: bool = False  # one drain runner per request at a time
    finish_pending: bool = False  # retired: the drain runner finalizes
    voc_fed: int = 0  # frames handed to the incremental vocoder so far
    voc_tail: Optional[np.ndarray] = None  # [ctx, 16] rolling left context
    audio_parts: List[np.ndarray] = field(default_factory=list)
    first_audio_at: Optional[float] = None


class PoolStream:
    """Handle for a streaming pool request: iterate to receive np.float32
    audio chunks (24 kHz) as the request decodes inside the shared pool
    batch; the final item is the SynthesisResult (same contract as
    TTSEngine.synthesize_stream).  ``future`` resolves with the result."""

    def __init__(self, req: _PoolRequest):
        self._req = req
        self.future: Future = req.future

    def __iter__(self):
        while True:
            item = self._req.chunk_q.get()
            if item is _STREAM_DONE:
                break
            yield item
        yield self.future.result()  # raises if the request failed


class ContinuousBatcher:
    """Drop-in alternative to BatchingServer with continuous admission.

    Same surface: ``submit`` -> Future[SynthesisResult], ``synthesize``,
    ``stats``, ``shutdown``; composes with ``make_http_server``.
    """

    def __init__(
        self,
        engine: TTSEngine,
        pool_size: int = 8,
        chunk_len: int = 16,
        kv_bucket: int = 512,
        text_bucket_max: Optional[int] = None,
        seed: int = 0,
        spec_k: Optional[int] = None,
        spec_iters: int = 2,
    ):
        if not engine.is_ready():
            raise EngineError(f"engine not ready: {engine.get_error()}")
        if engine.mesh is not None:
            data = engine.mesh.shape.get("data", 1)
            if int(pool_size) % max(data, 1) != 0:
                raise EngineError(
                    f"pool_size ({pool_size}) must divide over the mesh "
                    f"data axis ({data})"
                )
        self.engine = engine
        self.cfg = engine.cfg
        self.pool_size = int(pool_size)
        self.chunk_len = int(chunk_len)
        self.kv_bucket = int(kv_bucket)
        if text_bucket_max is None:
            # derive from the pool's own KV budget: text drips one token per
            # generated frame, so prompts beyond ~kv_bucket tokens could
            # never finish dripping anyway.  (The round-3 fixed default of
            # 64 rejected two-sentence prompts the ENGINE handled fine.)
            text_bucket_max = _round_up(min(self.kv_bucket, 512), 16)
        self.text_bucket_max = int(text_bucket_max)
        # speculative mode: one S=K verify pass covers pool_size*K frame
        # slots per iteration with per-slot acceptance (runtime/speculative)
        if spec_k is not None and not 2 <= int(spec_k) <= 8:
            raise ValueError("spec_k must be in [2, 8]")
        self.spec_k = int(spec_k) if spec_k else None
        self.spec_iters = max(1, int(spec_iters))

        cfg = self.cfg
        self._seed = int(seed)
        self._prefill_cache: Dict[tuple, object] = {}
        self._splice_cache: Dict[int, object] = {}
        self._vocode_cache: Dict[int, object] = {}

        if self.spec_k:
            from ..runtime.speculative import decode_frames_spec, repeat_draft

            if cfg.draft is not None and "draft" in (engine.params or {}):
                from ..models.draft import model_draft_fn

                draft_fn = model_draft_fn(
                    cfg.draft, engine.params["draft"],
                    engine.params["embeddings"],
                )
            else:
                draft_fn = repeat_draft
            k, iters = self.spec_k, self.spec_iters

            def dec(params, state, trailing, trailing_len, pad, sp):
                return decode_frames_spec(
                    cfg, params, state, trailing, trailing_len, pad, sp,
                    k, iters, draft_fn,
                )

            self._decode = jax.jit(dec, donate_argnums=(1,))
        else:
            # uniform_fill=False: pool slots run at DIFFERENT fill levels, so
            # the cache write takes the per-sequence scatter path
            self._fns = make_generate_fns(cfg, batch=self.pool_size,
                                          max_len=self.kv_bucket,
                                          chunk_len=self.chunk_len,
                                          uniform_fill=False)
            self._decode = self._fns.decode
        self._state = self._make_idle_state()
        B = self.pool_size
        H = cfg.talker.hidden_size
        dt = cfg.talker.transformer.jnp_dtype
        self._trailing = jnp.zeros((B, self.text_bucket_max, H), dt)
        self._trailing_len = jnp.zeros((B,), jnp.int32)
        if engine.mesh is not None:
            self._trailing = self._put(self._trailing, 0)
            self._trailing_len = self._put(self._trailing_len, 0)
        from ..models.embeddings import text_project
        from ..config import TTS_PAD

        self._tts_pad = jax.jit(
            lambda p: text_project(p, jnp.asarray(TTS_PAD, jnp.int32))
        )(engine.params["embeddings"])

        # host-side per-slot sampling knobs ([B] vectors into the decode jit)
        self._temps = np.full((B,), 0.8, np.float32)
        self._top_ks = np.full((B,), 50, np.int32)
        self._top_ps = np.full((B,), 0.95, np.float32)
        self._forbid = np.zeros((B,), bool)

        self._slots: List[Optional[_Active]] = [None] * B
        self._queue: "queue.Queue[_PoolRequest]" = queue.Queue()
        self._stop = threading.Event()
        self._requests_done = 0
        self._chunks_run = 0
        self._admits = 0  # per-request PRNG derivation counter
        # Async admission: prefills (whole-transformer forward + possible
        # first-time bucket/lang compile) run on worker threads; the decode
        # loop only SPLICES finished prefills at chunk boundaries, so a
        # cold-signature admission never freezes decode for the active slots
        # (round-3 verdict #4).  Workers also AOT-compile the bucket's
        # splice program so the decode-thread splice is dispatch-only.
        self._reserved = [False] * B  # slots held by in-flight prefills
        self._ready: "queue.Queue[tuple]" = queue.Queue()
        self._admit_exec = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="pool-admit"
        )
        self._compile_lock = threading.Lock()  # one compile per signature
        # adaptive spec (aggregate): per-stream spec modes are not
        # SPMD-expressible (one decode program covers every slot), so the
        # pool tracks POOL-WIDE trailing acceptance and, when it stays below
        # the engine's spec_accept_floor, converts the whole state to
        # sequential (runtime/speculative.spec_to_seq batched) — after which
        # spec can never underperform the plain pool
        self._acc_slots = 0
        self._acc_iters = 0
        self._spec_fallback = False
        # Retirement vocoding runs off the decode loop (see _retire).
        # Workers scale with the pool so a burst of simultaneous retirements
        # (their slots already re-admitted) doesn't serialize all vocoding
        # behind one thread — a latency cliff at larger pools (round-2
        # verdict).  Python threads suffice: the work is jitted device
        # dispatch + host assembly, which releases the GIL.
        self._finisher = ThreadPoolExecutor(
            max_workers=max(2, self.pool_size // 4),
            thread_name_prefix="pool-retire",
        )
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _text_for_bucket(self, bucket: int) -> str:
        """A text whose BPE length rounds up to exactly ``bucket``."""
        words, text = ["a"], "a"
        while _round_up(len(self.engine._tokenize(text)), 16) < bucket:
            words.append("a")
            text = " ".join(words)
        return text

    def warmup(
        self,
        languages=("auto",),
        text_buckets=None,
        streaming: bool = True,
    ) -> float:
        """Pre-compile the pool's programs by running tiny requests through
        the live pool — the first real requests then skip the compile cliffs.

        Covers every (text-bucket, language) signature the deployment
        declares (prefill runs on the admission workers, so signatures
        compile CONCURRENTLY), the persistent decode dispatch, the splice
        per bucket, retirement vocode, and (``streaming``) the incremental
        per-chunk vocode path.  Requires a tokenizer; returns seconds."""
        import time as _time

        t0 = _time.perf_counter()
        if text_buckets is None:
            text_buckets = (16,)
        texts = {b: self._text_for_bucket(b) for b in text_buckets}
        futs = [
            self.submit(texts[b], language=lang, temperature=0.0,
                        max_tokens=self.chunk_len)
            for lang in languages
            for b in text_buckets
        ]
        handles = []
        if streaming:
            handles.append(
                self.submit_stream(texts[min(text_buckets)],
                                   temperature=0.0,
                                   max_tokens=2 * self.chunk_len)
            )
        for f in futs:
            f.result()
        for h in handles:
            list(h)
        dt = _time.perf_counter() - t0
        log.info("pool warmup done in %.1fs", dt)
        return dt

    # ------------------------------------------------------------------
    def submit(
        self,
        text: str,
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        forbid_eos: bool = False,
        seed: Optional[int] = None,
    ) -> "Future[SynthesisResult]":
        if self._stop.is_set():
            raise RuntimeError("server is shut down")
        req = _PoolRequest(text, language, temperature, top_k, top_p,
                           max_tokens, forbid_eos, seed)
        self._queue.put(req)
        return req.future

    def synthesize(self, text: str, **kw) -> SynthesisResult:
        return self.submit(text, **kw).result()

    def submit_stream(
        self,
        text: str,
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> PoolStream:
        """Streaming synthesis THROUGH the continuous pool: the request
        decodes in the shared SPMD batch (full batching throughput) while
        its committed frames vocode incrementally per dispatch — first audio
        after one decode chunk, not at retirement.  Returns a PoolStream:
        iterate for audio chunks, final item is the SynthesisResult.

        The reference vocodes once at the end (tts_onnx.cpp:430); the
        round-3 HTTP streaming path bypassed batching with a private B=1
        decode — this is the production path that does both."""
        if self._stop.is_set():
            raise RuntimeError("server is shut down")
        req = _PoolRequest(text, language, temperature, top_k, top_p,
                           max_tokens, seed=seed, stream=True,
                           chunk_q=queue.Queue())
        self._queue.put(req)
        return PoolStream(req)

    @property
    def stats(self) -> dict:
        return {
            "chunks": self._chunks_run,
            "requests": self._requests_done,
            "queued": self._queue.qsize(),
            "active": sum(s is not None for s in self._slots),
            "spec_fallback": self._spec_fallback,
        }

    def shutdown(self, wait: bool = True) -> None:
        self._stop.set()
        if wait:
            self._thread.join(timeout=60)
        self._admit_exec.shutdown(wait=wait)
        self._finisher.shutdown(wait=wait)

    # ------------------------------------------------------------------
    # jitted helpers (cached per signature)
    # ------------------------------------------------------------------

    def _put(self, x, axis):
        """device_put with the pool-batch axis sharded over "data"."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        spec = [None] * x.ndim
        if axis is not None:
            spec[axis] = "data"
        return jax.device_put(x, NamedSharding(self.engine.mesh, P(*spec)))

    def _shard_state(self, state):
        """Shard the pool state over the mesh: slots (the pool batch axis)
        over "data", everything else following GSPMD propagation from the
        TP-sharded params.  Host-side admit/retire stays unchanged — the
        splice jits reshard their 1-stream inputs automatically."""
        if self.engine.mesh is None:
            return state
        cache = state.cache
        cache = cache._replace(
            k=self._put(cache.k, 1),
            v=self._put(cache.v, 1),
            length=self._put(cache.length, 0),
        )
        if state.cache.k_scale is not None:
            cache = cache._replace(
                k_scale=self._put(state.cache.k_scale, 1),
                v_scale=self._put(state.cache.v_scale, 1),
            )
        rest = {
            # key is [B, 2] per-slot chains — sharded over "data" like every
            # other per-slot field
            f: self._put(getattr(state, f), 0)
            for f in state._fields
            if f != "cache"
        }
        return state._replace(cache=cache, **rest)

    def _make_idle_state(self):
        """Fresh all-slots-idle pool state.  Used at construction AND to
        recover after a failed dispatch: the decode jit donates the state,
        so after an exception the old buffers are deleted and the pool must
        rebuild (in-flight requests were already failed by the caller)."""
        cfg = self.cfg
        B, T = self.pool_size, self.kv_bucket
        t = cfg.talker.transformer
        H, V = cfg.talker.hidden_size, cfg.talker.codec_vocab_size
        dt = t.jnp_dtype
        cache = talker_init_cache(cfg.talker, B, T)
        # per-slot PRNG chains; idle rows are placeholders (the admission
        # splice overwrites slot keys with the request's chain)
        slot_keys = jnp.broadcast_to(jax.random.PRNGKey(self._seed), (B, 2))
        if self.spec_k:
            from ..runtime.speculative import SpecState

            return self._shard_state(SpecState(
                cache=cache,
                valid_mask=jnp.zeros((B, T), bool),
                pending=jnp.zeros((B, 16), jnp.int32),
                pending_nodrip=jnp.zeros((B, H), dt),
                pending_hidden=jnp.zeros((B, H), dt),
                rope_pos=jnp.zeros((B,), jnp.int32),
                step=jnp.ones((B,), jnp.int32),
                done=jnp.ones((B,), bool),  # empty slots idle as "done"
                key=slot_keys,
            ))
        return self._shard_state(GenerateState(
            cache=cache,
            valid_mask=jnp.zeros((B, T), bool),
            last_logits=jnp.zeros((B, V), jnp.float32),
            # MODEL dtype, not f32: the decode scan carries last_hidden and
            # the talker emits it in the transformer dtype — a f32 idle state
            # type-mismatched the scan on bf16 checkpoints (the f32 tiny
            # test model cannot see it; chip_smoke.py runs bf16)
            last_hidden=jnp.zeros((B, H), dt),
            pos=jnp.zeros((B,), jnp.int32),
            step=jnp.zeros((B,), jnp.int32),
            done=jnp.ones((B,), bool),  # empty slots idle as "done"
            key=slot_keys,
        ))

    def _get_prefill(self, t_bucket: int, lang_id):
        """(prefill, decode) for admission: the chunk-1 decode bootstraps
        frame 0 on the admission worker so a streaming request's first
        audio leaves at the SPLICE instead of after the next full pooled
        chunk (round-4 verdict #6 — pooled TTFA)."""
        key = (t_bucket, lang_id)
        if key not in self._prefill_cache:
            fns = make_generate_fns(
                self.cfg, batch=1, max_len=self.kv_bucket, chunk_len=1,
                lang_id=lang_id,
            )
            self._prefill_cache[key] = (fns.prefill, fns.decode)
        return self._prefill_cache[key]

    def _get_splice(self, t_bucket: int):
        if t_bucket not in self._splice_cache:
            TB = self.text_bucket_max

            def splice(state, trailing, trailing_len, slot,
                       cache1, valid1, logits1, hidden1, pos1, step1,
                       done1, key1, t1, t1len):
                from ..models.layers import splice_kv_cache

                cache = splice_kv_cache(state.cache, cache1, slot)
                new = state._replace(
                    cache=cache,
                    valid_mask=jax.lax.dynamic_update_slice(
                        state.valid_mask, valid1, (slot, 0)
                    ),
                    last_logits=jax.lax.dynamic_update_slice(
                        state.last_logits, logits1, (slot, 0)
                    ),
                    last_hidden=jax.lax.dynamic_update_slice(
                        state.last_hidden,
                        hidden1.astype(state.last_hidden.dtype), (slot, 0),
                    ),
                    pos=jax.lax.dynamic_update_slice(state.pos, pos1, (slot,)),
                    # step/done from the admission bootstrap: frame 0 was
                    # decoded at admission (step=1; done latched if frame 0
                    # hit EOS) so the drip index and the EOS latch carry over
                    step=jax.lax.dynamic_update_slice(
                        state.step, step1, (slot,)
                    ),
                    done=jax.lax.dynamic_update_slice(
                        state.done, done1, (slot,)
                    ),
                    # the request's own PRNG chain into its slot row
                    key=jax.lax.dynamic_update_slice(
                        state.key, key1[None, :], (slot, 0)
                    ),
                )
                row = jnp.zeros((1, TB, trailing.shape[2]), trailing.dtype)
                row = jax.lax.dynamic_update_slice(row, t1, (0, 0, 0))
                trailing = jax.lax.dynamic_update_slice(
                    trailing, row, (slot, 0, 0)
                )
                trailing_len = jax.lax.dynamic_update_slice(
                    trailing_len, t1len, (slot,)
                )
                return new, trailing, trailing_len

            self._splice_cache[t_bucket] = jax.jit(
                splice, donate_argnums=(0, 1, 2)
            )
        return self._splice_cache[t_bucket]

    def _warm_splice(self, t_bucket: int, s1, bundle) -> None:
        """AOT-compile the sequential splice for this bucket on the CALLING
        (admission worker) thread, so the decode thread's splice is a
        dispatch of an already-compiled program.  Lowering only reads
        avals/shardings of the example args — safe concurrently with the
        decode loop.  Falls back silently to lazy jit compile.

        Mesh pools skip AOT: the pool state's shardings are not stable
        across dispatches (GSPMD propagates e.g. a 'model' factor onto the
        KV heads dim after the first decode), and a Compiled object pins
        the shardings it lowered with — the plain jit reshards/recompiles
        transparently instead (measured: the splice graph is tiny)."""
        if self.engine.mesh is not None:
            return
        key = ("compiled", t_bucket)
        if key in self._splice_cache:
            return
        with self._compile_lock:
            if key in self._splice_cache:
                return
            try:
                fn = self._get_splice(t_bucket)
                compiled = fn.lower(
                    self._state, self._trailing, self._trailing_len,
                    jnp.asarray(0, jnp.int32),
                    s1.cache, s1.valid_mask,
                    s1.last_logits, s1.last_hidden, s1.pos, s1.step,
                    s1.done, s1.key,
                    bundle.trailing, bundle.trailing_len,
                ).compile()
                self._splice_cache[t_bucket] = compiled
            except Exception:  # pragma: no cover - lazy path still works
                log.exception("splice AOT compile failed; falling back")
            self._splice_cache[key] = True

    def _get_spec_prefill(self, t_bucket: int, lang_id):
        key = ("spec", t_bucket, lang_id)
        if key not in self._prefill_cache:
            from ..runtime.speculative import make_spec_generate_fns

            self._prefill_cache[key] = make_spec_generate_fns(
                self.cfg, max_len=self.kv_bucket, k=self.spec_k,
                num_iters=self.spec_iters, batch=1, lang_id=lang_id,
                donate=False,
            ).prefill
        return self._prefill_cache[key]

    def _get_spec_splice(self, t_bucket: int):
        key = ("spec_splice", t_bucket)
        if key not in self._splice_cache:
            TB = self.text_bucket_max

            def splice(state, trailing, trailing_len, slot,
                       cache1, valid1, pend1, nod1, hid1, rope1, done1,
                       key1, t1, t1len):
                from ..models.layers import splice_kv_cache

                dus = jax.lax.dynamic_update_slice
                cache = splice_kv_cache(state.cache, cache1, slot)
                new = state._replace(
                    cache=cache,
                    valid_mask=dus(state.valid_mask, valid1, (slot, 0)),
                    pending=dus(state.pending, pend1, (slot, 0)),
                    pending_nodrip=dus(
                        state.pending_nodrip,
                        nod1.astype(state.pending_nodrip.dtype), (slot, 0),
                    ),
                    pending_hidden=dus(
                        state.pending_hidden,
                        hid1.astype(state.pending_hidden.dtype), (slot, 0),
                    ),
                    rope_pos=dus(state.rope_pos, rope1, (slot,)),
                    step=dus(
                        state.step, jnp.ones((1,), jnp.int32), (slot,)
                    ),
                    done=dus(state.done, done1, (slot,)),
                    # the request's chain, already advanced past frame 0
                    # (the spec prefill sampled the bootstrap frame with it)
                    key=dus(state.key, key1[None, :], (slot, 0)),
                )
                row = jnp.zeros((1, TB, trailing.shape[2]), trailing.dtype)
                row = jax.lax.dynamic_update_slice(row, t1, (0, 0, 0))
                trailing = dus(trailing, row, (slot, 0, 0))
                trailing_len = dus(trailing_len, t1len, (slot,))
                return new, trailing, trailing_len

            self._splice_cache[key] = jax.jit(
                splice, donate_argnums=(0, 1, 2)
            )
        return self._splice_cache[key]

    def _warm_spec_splice(self, t_bucket: int, s1, bundle) -> None:
        """Spec-mode twin of _warm_splice (same mesh caveat)."""
        if self.engine.mesh is not None:
            return
        ck = ("compiled_spec", t_bucket)
        if ck in self._splice_cache:
            return
        with self._compile_lock:
            if ck in self._splice_cache:
                return
            try:
                fn = self._get_spec_splice(t_bucket)
                compiled = fn.lower(
                    self._state, self._trailing, self._trailing_len,
                    jnp.asarray(0, jnp.int32),
                    s1.cache, s1.valid_mask,
                    s1.pending, s1.pending_nodrip, s1.pending_hidden,
                    s1.rope_pos, s1.done, s1.key,
                    bundle.trailing, bundle.trailing_len,
                ).compile()
                self._splice_cache[("spec_splice", t_bucket)] = compiled
            except Exception:  # pragma: no cover - lazy path still works
                log.exception("spec splice AOT compile failed; falling back")
            self._splice_cache[ck] = True

    def _get_mark_done(self):
        if "mark_done" not in self._splice_cache:
            def mark(state, slot):
                return state._replace(
                    done=jax.lax.dynamic_update_slice(
                        state.done, jnp.ones((1,), bool), (slot,)
                    )
                )

            self._splice_cache["mark_done"] = jax.jit(mark, donate_argnums=(0,))
        return self._splice_cache["mark_done"]

    def _vocode(self, codes: np.ndarray) -> np.ndarray:
        """Length-bucketed whole-utterance vocode at retirement."""
        F = len(codes)
        if F == 0:
            return np.zeros((0,), np.float32)
        Fb = _round_up(F, self.chunk_len)
        if Fb not in self._vocode_cache:
            voc_cfg = self.cfg.vocoder
            self._vocode_cache[Fb] = jax.jit(
                lambda p, c: vocoder_forward(voc_cfg, p, c)
            )
        padded = np.zeros((1, Fb, 16), np.int32)
        padded[0, :F] = codes
        audio = self._vocode_cache[Fb](self.engine.params["vocoder"], padded)
        spf = self.cfg.vocoder.samples_per_frame
        return np.asarray(audio, np.float32)[0, : F * spf]

    # ------------------------------------------------------------------
    # streaming emitter (per-slot incremental vocode)
    # ------------------------------------------------------------------

    def _stream_vocode(self, active: _Active, frames_new: np.ndarray) -> np.ndarray:
        """Vocode ``frames_new`` [n, 16] with the request's rolling left
        context; returns the n*spf new audio samples.  Exact (== whole
        utterance vocode) once ctx >= left_context_frames — every vocoder op
        is causal (models/codec12hz.py).  The frame window right-pads to the
        pool's per-dispatch size so steady-state uses ONE jit signature
        (trailing zero frames cannot affect earlier samples: causality)."""
        voc_cfg = self.cfg.vocoder
        spf = voc_cfg.samples_per_frame
        L = voc_cfg.left_context_frames
        d = self.spec_k * self.spec_iters if self.spec_k else self.chunk_len
        n = len(frames_new)
        nb = _round_up(n, d)
        tail = active.voc_tail
        ctx = 0 if tail is None else len(tail)
        window = np.zeros((1, ctx + nb, 16), np.int32)
        if ctx:
            window[0, :ctx] = tail
        window[0, ctx : ctx + n] = frames_new
        vf = self.engine._get_vocode_fn(ctx + nb, ctx)  # shared compile cache
        audio = np.asarray(
            vf(self.engine.params["vocoder"], jnp.asarray(window)), np.float32
        )[0, : n * spf]
        allf = frames_new if tail is None else np.concatenate([tail, frames_new])
        active.voc_tail = allf[max(0, len(allf) - min(L, len(allf))) :]
        return audio

    def _drain_stream(self, active: _Active) -> None:
        """Emit audio for every committed-but-unvocoded frame of a streaming
        request.  Runs on a finisher thread (never the decode loop); the
        emit_busy flag keeps exactly ONE runner per request so chunks vocode
        and emit strictly in order.  After retirement (finish_pending) the
        runner also finalizes the request — retirement never BLOCKS a
        finisher worker waiting on a queued drain task (with few workers
        that wait could deadlock the executor)."""
        while True:
            with active.emit_lock:
                total = min(len(active.frames), active.budget)
                n_new = total - active.voc_fed
                if n_new <= 0:
                    if active.finish_pending:
                        active.finish_pending = False  # sole finalizer
                    else:
                        active.emit_busy = False
                        return
                    finalize = True
                else:
                    frames_new = np.stack(active.frames[active.voc_fed : total])
                    active.voc_fed = total
                    finalize = False
            if finalize:
                try:
                    self._finalize_stream(active)
                finally:
                    with active.emit_lock:
                        active.emit_busy = False
                return
            audio = self._stream_vocode(active, frames_new)
            active.audio_parts.append(audio)
            if active.first_audio_at is None:
                active.first_audio_at = time.perf_counter()
            active.req.chunk_q.put(audio)

    def _drain_stream_safe(self, active: _Active) -> None:
        try:
            self._drain_stream(active)
        except Exception as e:  # pragma: no cover
            log.exception("stream vocode failed")
            with active.emit_lock:
                active.emit_busy = False
            self._fail_request(active.req, e)

    def _kick_stream(self, active: _Active) -> None:
        """Schedule a drain runner if none is active (called from the decode
        loop after new frames commit — cheap: a flag check + submit)."""
        with active.emit_lock:
            if active.emit_busy:
                return  # the live runner will pick the new frames up
            active.emit_busy = True
        self._finisher.submit(self._drain_stream_safe, active)

    @staticmethod
    def _fail_request(req: _PoolRequest, exc: Exception) -> None:
        if not req.future.done():
            req.future.set_exception(exc)
        if req.chunk_q is not None:
            req.chunk_q.put(_STREAM_DONE)  # unblock the iterator

    # ------------------------------------------------------------------
    # pool loop
    # ------------------------------------------------------------------

    def _derive_admit_key(self, req: _PoolRequest):
        """Per-request chain root: seeded requests derive from (pool seed,
        request seed) ONLY — never the admit counter — so the same (text,
        seed) resamples identically at any pool occupancy (the slot key
        then advances one split per frame of ITS OWN decode).  Unseeded
        requests fold the admit counter for a fresh chain per admission.
        The domain separator (1 vs 0) keeps user seeds and counter values
        from colliding on the same chain.  Called on the decode thread
        (the _admits counter needs no lock there)."""
        root = jax.random.PRNGKey(self._seed)
        if req.seed is not None:
            admit_key = jax.random.fold_in(
                jax.random.fold_in(root, 1), int(req.seed)
            )
        else:
            admit_key = jax.random.fold_in(
                jax.random.fold_in(root, 0), self._admits
            )
        self._admits += 1
        return admit_key

    def _prefill_request(self, slot: int, req: _PoolRequest, admit_key) -> None:
        """ADMISSION WORKER (off the decode loop): tokenize, run the batch-1
        prefill (including any first-time (bucket, lang) compile) and
        AOT-compile the bucket's splice, then hand the result to the decode
        thread via _ready.  The decode loop's only admission work is the
        pre-compiled splice dispatch — a cold-signature admission no longer
        freezes every active slot (round-3 verdict #4)."""
        try:
            eng = self.engine
            ids = eng._tokenize(req.text)
            vocab = self.cfg.talker.text_vocab_size
            bad = [i for i in ids if not 0 <= int(i) < vocab]
            if bad:
                raise EngineError(
                    f"token id(s) out of range [0, {vocab}): {bad[:8]}"
                )
            t_bucket = _round_up(len(ids), 16)
            if t_bucket > self.text_bucket_max:
                raise EngineError(
                    f"text too long for the pool ({len(ids)} tokens > "
                    f"{self.text_bucket_max} bucket)"
                )
            lang_id = language_to_codec_id(
                req.language if req.language != "auto" else None
            )
            P = prompt_length(lang_id, False, 0)
            spec = self.spec_k is not None  # snapshot: may flip to sequential
            per_dispatch = (
                self.spec_k * self.spec_iters if spec else self.chunk_len
            )
            budget = self.kv_bucket - P - per_dispatch
            if budget < 1:
                raise EngineError("pool kv_bucket too small for the prompt")
            if req.max_tokens is not None:
                budget = min(budget, int(req.max_tokens))

            ids_arr = np.zeros((1, t_bucket), np.int32)
            ids_arr[0, : len(ids)] = ids
            lens = np.asarray([len(ids)], np.int32)
            if spec:
                sp1 = SamplingParams.create(
                    req.temperature, req.top_k, req.top_p,
                    forbid_eos=req.forbid_eos,
                )
                prefill = self._get_spec_prefill(t_bucket, lang_id)
                s1, bundle, frame0, valid0 = prefill(
                    self.engine.params, ids_arr, lens, admit_key, sp1
                )
                self._warm_spec_splice(t_bucket, s1, bundle)
                payload = (True, t_bucket, budget, s1, bundle,
                           np.asarray(frame0)[0], bool(np.asarray(valid0)[0]))
            else:
                prefill, decode1 = self._get_prefill(t_bucket, lang_id)
                s1, bundle = prefill(
                    self.engine.params, ids_arr, lens, admit_key
                )
                frame0, valid0 = None, False
                if req.stream:
                    # bootstrap frame 0 on the admission worker (chunk-1
                    # B=1 decode): first audio leaves at the splice, not
                    # after the next full pooled chunk.  The post-bootstrap
                    # state carries step=1 (drip index) and the EOS latch.
                    # STREAMING requests only: the host sync below stalls
                    # the admission worker, and non-streaming requests
                    # gain nothing from an early frame 0 (TTFA is a
                    # streaming metric).
                    sp1 = SamplingParams.create(
                        req.temperature, req.top_k, req.top_p,
                        forbid_eos=req.forbid_eos,
                    )
                    s1, f0, v0 = decode1(
                        self.engine.params, s1, bundle.trailing,
                        bundle.trailing_len, bundle.tts_pad_embed, sp1,
                    )
                    frame0 = np.asarray(f0)[0, 0]
                    valid0 = bool(np.asarray(v0)[0, 0])
                self._warm_splice(t_bucket, s1, bundle)
                payload = (False, t_bucket, budget, s1, bundle,
                           frame0, valid0)
            self._ready.put((slot, req, admit_key, payload))
        except Exception as e:
            log.exception("admission prefill failed")
            self._ready.put((slot, req, admit_key, e))

    def _splice_ready(self) -> None:
        """Decode thread: splice every finished admission prefill into the
        pool state (pre-compiled dispatch only)."""
        while True:
            try:
                slot, req, admit_key, payload = self._ready.get_nowait()
            except queue.Empty:
                return
            if isinstance(payload, Exception):
                self._reserved[slot] = False
                self._fail_request(req, payload)
                continue
            spec, t_bucket, budget, s1, bundle, frame0, valid0 = payload
            if spec != (self.spec_k is not None):
                # the pool switched decode modes (adaptive spec fallback)
                # while this prefill was in flight: redo it in today's mode
                self._admit_exec.submit(
                    self._prefill_request, slot, req, admit_key
                )
                continue
            try:
                self._splice_one(slot, req, spec, t_bucket, budget, s1,
                                 bundle, frame0, valid0)
            except Exception as e:
                # the splice donates the pool state: rebuild it and fail
                # every in-flight request (same recovery as a failed decode
                # dispatch) — the loop itself must survive
                log.exception("admission splice failed; rebuilding pool state")
                self._reserved[slot] = False
                self._fail_request(req, e)
                for s, act in enumerate(self._slots):
                    if act is not None:
                        self._fail_request(act.req, e)
                    self._slots[s] = None
                self._state = self._make_idle_state()

    def _splice_one(self, slot, req, spec, t_bucket, budget, s1, bundle,
                frame0, valid0) -> None:
        active = _Active(req=req, budget=budget)
        if spec:
            splice = self._get_spec_splice(t_bucket)
            self._state, self._trailing, self._trailing_len = splice(
                self._state, self._trailing, self._trailing_len,
                jnp.asarray(slot, jnp.int32),
                s1.cache, s1.valid_mask,
                s1.pending, s1.pending_nodrip, s1.pending_hidden,
                s1.rope_pos, s1.done, s1.key,
                bundle.trailing, bundle.trailing_len,
            )
            # the spec bootstrap already committed frame 0
            if valid0 and budget >= 1:
                active.frames.append(frame0)
        else:
            splice = self._get_splice(t_bucket)
            self._state, self._trailing, self._trailing_len = splice(
                self._state, self._trailing, self._trailing_len,
                jnp.asarray(slot, jnp.int32),
                s1.cache, s1.valid_mask,
                s1.last_logits, s1.last_hidden, s1.pos, s1.step,
                s1.done, s1.key,
                bundle.trailing, bundle.trailing_len,
            )
            # the admission bootstrap already committed frame 0
            if valid0 and budget >= 1:
                active.frames.append(frame0)
        self._temps[slot] = req.temperature
        self._top_ks[slot] = req.top_k
        self._top_ps[slot] = req.top_p
        self._forbid[slot] = req.forbid_eos
        self._slots[slot] = active
        self._reserved[slot] = False
        if req.stream and active.frames:
            self._kick_stream(active)  # spec frame 0: earliest TTFA

    def _retire(self, slot: int) -> None:
        """Free the slot immediately; vocode + future resolution run on the
        finisher pool so a long utterance's whole-sequence vocode (plus any
        first-time length-bucket compile) never stalls the decode loop —
        that would reintroduce the head-of-line blocking this pool exists to
        remove.  Multiple workers keep a retirement burst from serializing
        (requests resolve independently; FIFO is not required)."""
        active = self._slots[slot]
        self._slots[slot] = None
        self._state = self._get_mark_done()(
            self._state, jnp.asarray(slot, jnp.int32)
        )
        self._requests_done += 1
        if active.req.stream:
            # the drain runner finalizes once it has vocoded every frame
            # (chained, never blocking a finisher worker on another task)
            with active.emit_lock:
                active.finish_pending = True
                if active.emit_busy:
                    return  # live runner picks finish_pending up
                active.emit_busy = True
            self._finisher.submit(self._drain_stream_safe, active)
        else:
            self._finisher.submit(self._finish, active)

    def _finish(self, active: "_Active") -> None:
        try:
            codes = (
                np.stack(active.frames).astype(np.int32)
                if active.frames else np.zeros((0, 16), np.int32)
            )
            codes = codes[: active.budget]
            audio = self._vocode(codes)
            self._resolve(active, codes, audio)
        except Exception as e:  # pragma: no cover
            self._fail_request(active.req, e)

    def _finalize_stream(self, active: "_Active") -> None:
        """Resolve a retired streaming request: every frame was already
        vocoded incrementally (the drain runner calls this only when
        drained), so the final audio IS the streamed concatenation —
        bit-identical to what the iterator consumer heard."""
        try:
            codes = (
                np.stack(active.frames).astype(np.int32)
                if active.frames else np.zeros((0, 16), np.int32)
            )
            codes = codes[: active.budget]
            audio = (
                np.concatenate(active.audio_parts)
                if active.audio_parts else np.zeros((0,), np.float32)
            )
            self._resolve(active, codes, audio)
        except Exception as e:  # pragma: no cover
            self._fail_request(active.req, e)

    def _resolve(self, active: "_Active", codes, audio) -> None:
        now = time.perf_counter()
        spf = self.cfg.vocoder.samples_per_frame
        m = SynthesisMetrics(
            audio_seconds=len(codes) * spf / float(SAMPLE_RATE),
            frames=len(codes),
            total_seconds=now - active.req.enqueued_at,
        )
        if active.first_audio_at is not None:
            m.ttfa_seconds = active.first_audio_at - active.req.enqueued_at
        m.stage_seconds["queued"] = active.admitted_at - active.req.enqueued_at
        active.req.future.set_result(
            SynthesisResult(audio=audio, codes=codes, metrics=m)
        )
        if active.req.chunk_q is not None:
            active.req.chunk_q.put(_STREAM_DONE)

    def _try_admissions(self) -> None:
        """Decode thread: hand queued requests to admission workers (one per
        free, unreserved slot).  The actual prefill happens off-thread; the
        splice lands via _splice_ready at a later chunk boundary."""
        for slot in range(self.pool_size):
            if self._slots[slot] is not None or self._reserved[slot]:
                continue
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            self._reserved[slot] = True
            admit_key = self._derive_admit_key(req)
            self._admit_exec.submit(self._prefill_request, slot, req, admit_key)

    def _switch_to_sequential(self) -> None:
        """Adaptive-spec fallback: convert every slot's SpecState row into a
        sequential GenerateState (one talker step consuming each pending
        input) and swap the decode program.  Idle slots convert harmlessly
        (their rows are overwritten at the next admission splice)."""
        from ..runtime.generate import make_generate_fns
        from ..runtime.speculative import spec_to_seq

        cfg = self.cfg
        conv = jax.jit(
            lambda p, s, tr, tl, pad: spec_to_seq(
                cfg, p, s, tr, tl, pad, uniform_fill=False
            )
        )
        self._state = conv(
            self.engine.params, self._state, self._trailing,
            self._trailing_len, self._tts_pad,
        )
        self.spec_k = None
        self._fns = make_generate_fns(
            cfg, batch=self.pool_size, max_len=self.kv_bucket,
            chunk_len=self.chunk_len, uniform_fill=False,
        )
        self._decode = self._fns.decode
        self._spec_fallback = True

    def _loop(self) -> None:
        params = self.engine.params
        while not self._stop.is_set():
            self._splice_ready()
            self._try_admissions()
            if not any(s is not None for s in self._slots):
                time.sleep(0.002 if any(self._reserved) else 0.005)
                continue
            sp = SamplingParams.create(
                jnp.asarray(self._temps), jnp.asarray(self._top_ks),
                jnp.asarray(self._top_ps), forbid_eos=jnp.asarray(self._forbid),
            )
            try:
                self._state, frames, valid = self._decode(
                    params, self._state, self._trailing, self._trailing_len,
                    self._tts_pad, sp,
                )
                frames_np = np.asarray(frames)
                valid_np = np.asarray(valid)
                done_np = np.asarray(self._state.done)
            except Exception as e:  # pragma: no cover
                log.exception("pool decode failed; failing active requests")
                for slot, active in enumerate(self._slots):
                    if active is not None:
                        self._fail_request(active.req, e)
                    self._slots[slot] = None
                # the decode jit donated self._state: its buffers may now be
                # deleted, which would poison every future splice — rebuild
                # a fresh idle state so the pool keeps serving
                self._state = self._make_idle_state()
                continue
            self._chunks_run += 1
            if self.spec_k and self.engine.spec_accept_floor > 0:
                live = [
                    i for i in range(self.pool_size)
                    if self._slots[i] is not None and not bool(done_np[i])
                ]
                if live:
                    self._acc_iters += self.spec_iters * len(live)
                    self._acc_slots += int(valid_np[live].sum())
                if self._acc_iters >= max(self.engine.spec_adapt_window,
                                          2 * self.spec_iters):
                    accept = max(0, self._acc_slots - self._acc_iters) / max(
                        self._acc_iters * (self.spec_k - 1), 1
                    )
                    if accept < self.engine.spec_accept_floor:
                        log.info(
                            "pool spec acceptance %.2f < floor %.2f; "
                            "switching the pool to sequential decode", accept,
                            self.engine.spec_accept_floor,
                        )
                        self._switch_to_sequential()
                    else:
                        self._acc_slots = 0  # rolling window
                        self._acc_iters = 0
            for slot, active in enumerate(self._slots):
                if active is None:
                    continue
                n_before = len(active.frames)
                for frame, ok in zip(frames_np[slot], valid_np[slot]):
                    if ok and len(active.frames) < active.budget:
                        active.frames.append(frame)
                if bool(done_np[slot]) or len(active.frames) >= active.budget:
                    self._retire(slot)  # streaming: retire chains the drain
                elif active.req.stream and len(active.frames) > n_before:
                    self._kick_stream(active)  # incremental audio per chunk
        # drain on shutdown
        for active in self._slots:
            if active is not None:
                self._fail_request(active.req, RuntimeError("server shut down"))
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            self._fail_request(r, RuntimeError("server shut down"))
        while True:  # prefilled-but-unspliced admissions
            try:
                _, r, _, _ = self._ready.get_nowait()
            except queue.Empty:
                break
            self._fail_request(r, RuntimeError("server shut down"))
