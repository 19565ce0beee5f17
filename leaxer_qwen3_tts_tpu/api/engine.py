"""TTSEngine: the top-level synthesis API (reference class TTSEngine parity).

Covers the reference surface (tts_onnx.h:118-164): ``synthesize``,
``synthesize_clone``, ``synthesize_speaker``, ``synthesize_tokens``,
``extract_speaker_embedding``, ``has_speaker_encoder``, ``is_ready``,
``get_error`` — plus what the reference lacks: seeded determinism, streaming
synthesis (audio chunks yielded before EOS), batched multi-utterance calls,
and per-stage metrics (RTF / TTFA).

Execution model: one jitted prefill + one jitted decode-chunk function per
(batch, text-bucket, language, speaker?) signature, cached; the decode chunk
runs ``chunk_len`` frames of talker + MTP + sampling fully on device.  The
vocoder runs as a jitted streaming chunk (causal left-context) so first audio
is out after the first decode chunk, not after EOS (the reference vocodes once
at the end, tts_onnx.cpp:430).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    IM_END,
    IM_START,
    MAX_NEW_TOKENS,
    SAMPLE_RATE,
    TTS_BOS,
    TTS_EOS,
    TTSModelConfig,
    language_to_codec_id,
    PRESET_SPEAKERS,
)
from ..frontend import Tokenizer, find_tokenizer_files, log_mel, read_wav, resample
from ..models.codec12hz import vocoder_forward
from ..models.speaker_encoder import speaker_encoder_forward
from ..runtime.generate import make_generate_fns
from ..runtime.sampling import SamplingParams
from ..runtime.weights import load_checkpoint
from ..utils.logging import get_logger
from ..utils.metrics import StageTimer, SynthesisMetrics
from ..utils.profiling import maybe_trace

log = get_logger(__name__)


class EngineError(RuntimeError):
    """Typed engine failure (replaces the reference's empty-vector returns)."""


class SynthesisResult(NamedTuple):
    audio: np.ndarray  # [T] float32 mono 24 kHz (or [B, T] for batched calls)
    codes: np.ndarray  # [frames, 16] int32 (or list per batch element)
    metrics: SynthesisMetrics


def _round_up(n: int, multiple: int) -> int:
    return ((max(n, 1) + multiple - 1) // multiple) * multiple


class TTSEngine:
    """Qwen3-TTS engine.

    Construct from a checkpoint dir (``config.json`` + weights, see
    runtime/weights.py) or directly from (config, params) pytrees.  Like the
    reference ctor (tts_onnx.cpp:84-130), construction records errors instead
    of raising; check ``is_ready()`` / ``get_error()``.
    """

    def __init__(
        self,
        model_dir: Optional[str] = None,
        *,
        config: Optional[TTSModelConfig] = None,
        params: Optional[dict] = None,
        tokenizer: Optional[Tokenizer] = None,
        max_frames: int = MAX_NEW_TOKENS,
        chunk_len: int = 32,
        first_chunk_len: int = 8,
        text_bucket: int = 16,
        quantize: Optional[str] = None,
        fuse: bool = True,
        kv_buckets: Tuple[int, ...] = (256, 512, 1024),
        mesh=None,
        spec_k: Optional[int] = None,
        spec_iters: int = 8,
        spec_accept_floor: float = 0.3,
        spec_adapt_window: int = 24,
        kv_quant: bool = False,
    ):
        self._ready = False
        self._error = ""
        self.cfg: Optional[TTSModelConfig] = None
        self.params: Optional[dict] = None
        self.tokenizer = tokenizer
        self.max_frames = int(max_frames)
        self.chunk_len = max(1, min(int(chunk_len), self.max_frames))
        # TTFA ramp: a small first decode chunk gets audio out early, then
        # full-size chunks carry the steady state
        self.first_chunk_len = max(1, min(int(first_chunk_len), self.chunk_len))
        # speculative frame decoding (runtime/speculative.py): verify spec_k
        # drafted frames per talker pass, spec_iters iterations per dispatch.
        # Single-stream (B=1) only — batching already amortizes weight reads.
        if spec_k is not None and not 2 <= int(spec_k) <= 8:
            raise ValueError("spec_k must be in [2, 8]")
        self.spec_k = int(spec_k) if spec_k is not None else None
        self.spec_iters = max(1, int(spec_iters))
        # adaptive spec: once >= spec_adapt_window verify iterations have run
        # with trailing acceptance below spec_accept_floor, the request
        # reverts to sequential decode (runtime/speculative.spec_to_seq) so
        # enabling spec costs little more than plain decode when drafts
        # miss.  0 disables the fallback.
        self.spec_accept_floor = float(spec_accept_floor)
        self.spec_adapt_window = max(1, int(spec_adapt_window))
        full = self.max_frames + 32
        # KV-cache bucket ladder: attention reads scale with the CURRENT
        # bucket, so early frames of a long-form request decode at
        # short-form cost; the cache is zero-padded up a bucket when the
        # write position approaches the boundary (at most len(ladder)
        # migrations per request).
        self.kv_ladder = tuple(
            sorted({b for b in kv_buckets if b < full} | {full})
        )
        self.text_bucket = int(text_bucket)
        self.mesh = mesh
        self._fns_cache: Dict[tuple, object] = {}
        self._vocode_cache: Dict[tuple, Callable] = {}
        self._spk_fn = None

        try:
            if model_dir is not None:
                self.cfg, self.params = load_checkpoint(model_dir)
                if self.tokenizer is None:
                    found = find_tokenizer_files(model_dir)
                    if found is not None:
                        self.tokenizer = Tokenizer(found[0], found[1])
                    else:
                        log.warning(
                            "no vocab.json found for %s; text synthesis disabled "
                            "(token-level API still available)", model_dir,
                        )
            else:
                if config is None or params is None:
                    raise EngineError("need model_dir or (config, params)")
                self.cfg, self.params = config, params
            if kv_quant:
                # int8 KV cache with per-slot scales on the TALKER only (the
                # MTP cache is <=64 slots — its bytes are noise).  Weight
                # quantization (``quantize``) is orthogonal.
                import dataclasses as _dc

                self.cfg = _dc.replace(
                    self.cfg,
                    talker=_dc.replace(
                        self.cfg.talker,
                        transformer=_dc.replace(
                            self.cfg.talker.transformer, kv_cache_quant=True
                        ),
                    ),
                )
            if fuse and mesh is None:
                # inference layout: one qkv matvec and one gate/up matvec per
                # layer (TP keeps the separate layout; rules key on wq/wk/...)
                from ..ops.quant import fuse_params

                self.params = fuse_params(self.params)
            if quantize not in (None, "int8", "int4"):
                raise EngineError(f"unknown quantize mode {quantize!r}")
            if quantize is not None and mesh is not None:
                raise EngineError(f"quantize={quantize} with a mesh is unsupported")
            if quantize is not None:
                # weight-only int8/int4 for the memory-bound decode
                # (ops/quant.py); embeddings/vocoder/speaker-encoder stay
                # full precision.
                from ..ops.quant import quantize_params

                self.params = quantize_params(
                    self.params, bits={"int8": 8, "int4": 4}[quantize]
                )
            if mesh is not None:
                # TP over "model" + DP over "data" (parallel/mesh.py rules);
                # GSPMD propagates KV-cache/activation shardings from these
                from ..parallel import shard_params as _shard_params

                self.params = _shard_params(mesh, self.params)
            self._ready = True
        except Exception as e:  # record, don't raise (reference ctor contract)
            self._error = str(e)
            log.error("engine init failed: %s", e)

    # ------------------------------------------------------------------
    # Status (reference tts_onnx.h:147-151)
    # ------------------------------------------------------------------

    def is_ready(self) -> bool:
        return self._ready

    def get_error(self) -> str:
        return self._error

    def has_speaker_encoder(self) -> bool:
        return bool(self._ready and "speaker_encoder" in (self.params or {}))

    # ------------------------------------------------------------------
    # Public synthesis API
    # ------------------------------------------------------------------

    def synthesize(
        self,
        text: str,
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        seed: int = 0,
        instruct: Optional[str] = None,
    ) -> SynthesisResult:
        """Text -> 24 kHz waveform (reference TTSEngine::synthesize).

        ``instruct``: optional voice-design instruction (the reference lists
        --instruct as planned for 1.7B-VoiceDesign, README.md roadmap)."""
        chunks: List[np.ndarray] = []
        result = None
        for item in self._synthesize_stream(
            [text], language, None, temperature, top_k, top_p, max_tokens, seed,
            instruct=instruct,
        ):
            if isinstance(item, SynthesisResult):
                result = item
            else:
                chunks.append(item)
        return result

    def synthesize_stream(
        self,
        text: str,
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        seed: int = 0,
        speaker_wav: Optional[str] = None,
        instruct: Optional[str] = None,
    ) -> Iterator[np.ndarray]:
        """Streaming synthesis: yields audio chunks (np float32 @24 kHz) as
        they decode; the final item is the SynthesisResult.  This is the
        <150 ms TTFA path the reference does not have."""
        speaker = (
            self.extract_speaker_embedding(speaker_wav)[None]
            if speaker_wav is not None
            else None
        )
        yield from self._synthesize_stream(
            [text], language, speaker, temperature, top_k, top_p, max_tokens, seed,
            instruct=instruct, streaming=True,
        )

    def synthesize_clone(
        self,
        text: str,
        ref_wav_path: str,
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        seed: int = 0,
        instruct: Optional[str] = None,
    ) -> SynthesisResult:
        """Voice clone from a ~3 s reference WAV (reference synthesize_clone,
        tts_onnx.cpp:264-318)."""
        spk = self.extract_speaker_embedding(ref_wav_path)
        result = None
        for item in self._synthesize_stream(
            [text], language, spk[None], temperature, top_k, top_p, max_tokens, seed,
            instruct=instruct,
        ):
            if isinstance(item, SynthesisResult):
                result = item
        return result

    def synthesize_speaker(
        self,
        text: str,
        speaker: str,
        language: str = "auto",
        **kw,
    ) -> SynthesisResult:
        """Preset-speaker synthesis (CustomVoice models).

        The reference stubs this out with a warning + plain fallback
        (tts_onnx.cpp:320-329); here it works whenever the checkpoint carries a
        ``speaker_table`` ([num_speakers, hidden]) and falls back identically
        when it does not."""
        name = speaker.lower()
        table = (self.params or {}).get("speaker_table")
        if table is None:
            log.warning(
                "model has no speaker_table (CustomVoice weights); "
                "falling back to default voice like the reference stub"
            )
            return self.synthesize(text, language, **kw)
        if name not in PRESET_SPEAKERS:
            raise EngineError(
                f"unknown speaker {speaker!r}; expected one of {sorted(PRESET_SPEAKERS)}"
            )
        spk = np.asarray(table[PRESET_SPEAKERS[name]], np.float32)
        result = None
        for item in self._synthesize_stream(
            [text], language, spk[None], **self._kw_to_sampling(kw)
        ):
            if isinstance(item, SynthesisResult):
                result = item
        return result

    def synthesize_batch(
        self,
        texts: Sequence[str],
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        seed=0,
    ) -> List[SynthesisResult]:
        """Batched multi-stream synthesis: all utterances decode in one SPMD
        batch; streams finish independently (EOS latching).  The reference is
        strictly batch-1 (SURVEY §2.3).

        ``seed`` may be an int (one shared PRNG chain, the historical
        behavior) or a length-B sequence of per-stream seeds: each stream
        then samples from its own chain, reproducible independent of its
        batch-mates."""
        items = list(
            self._synthesize_stream(
                list(texts), language, None, temperature, top_k, top_p, max_tokens, seed
            )
        )
        result = items[-1]
        assert isinstance(result, SynthesisResult)
        if len(texts) == 1:
            return [result]
        return [
            SynthesisResult(
                audio=result.audio[b], codes=result.codes[b], metrics=result.metrics[b]
            )
            for b in range(len(texts))
        ]

    def synthesize_tokens(
        self,
        token_ids: Sequence[int],
        language: str = "auto",
        temperature: float = 0.8,
        top_k: int = 50,
        top_p: float = 0.95,
        max_tokens: Optional[int] = None,
        seed: int = 0,
    ) -> SynthesisResult:
        """Synthesis from a pre-tokenized chat-wrapped sequence
        [IM_START, ASSISTANT, TTS_BOS, *text, TTS_EOS, IM_END]
        (reference synthesize_tokens, tts_onnx.cpp:405-436)."""
        ids = [int(i) for i in token_ids]
        if len(ids) >= 6 and ids[0] == IM_START and ids[-1] == IM_END:
            text_ids = ids[3:-2]  # strip role prefix + [TTS_EOS, IM_END]
        else:
            text_ids = [i for i in ids if i not in (IM_START, IM_END, TTS_BOS, TTS_EOS)]
        if not text_ids:
            raise EngineError("no text tokens in sequence")
        result = None
        for item in self._synthesize_ids_stream(
            [text_ids], language, None, temperature, top_k, top_p, max_tokens, seed
        ):
            if isinstance(item, SynthesisResult):
                result = item
        return result

    def warmup(self, language: str = "auto", languages=None,
               text_buckets=None) -> float:
        """Pre-compile the programs a serving deployment will hit, so first
        requests don't pay compile time.

        Runs one full-length synthesis per declared (text-bucket, language)
        signature (covers prefill, the TTFA first chunk, steady-state
        chunks, EVERY KV-ladder rung the budget reaches, and the
        streaming-vocode window shapes — exactly the request path, spec or
        sequential) plus one short synthesis (the early-EOS partial window).
        Defaults to the first text bucket and one language; pass the
        deployment's expected ``languages``/``text_buckets`` (token-count
        buckets, multiples of ``text_bucket``) for full coverage.  Returns
        the wall-clock seconds spent."""
        self._require_ready()
        import time as _time

        t0 = _time.perf_counter()
        if languages is None:
            languages = (language,)
        if text_buckets is None:
            text_buckets = (self.text_bucket,)
        long_frames = min(self.max_frames, self.kv_ladder[-1])
        for lang in languages:
            for tb in text_buckets:
                ids = [[5] * max(1, int(tb) - 2)]  # rounds up to bucket tb
                for mt in (long_frames, self.first_chunk_len):
                    for _ in self._synthesize_ids_stream(
                        ids, lang, None, 0.0, 50, 0.95, mt, 0
                    ):
                        pass
        dt = _time.perf_counter() - t0
        log.info("engine warmup done in %.1fs", dt)
        return dt

    def extract_speaker_embedding(self, wav_path: str) -> np.ndarray:
        """Reference WAV -> 1024-dim speaker embedding (reference
        extract_speaker_embedding, tts_onnx.cpp:331-365: read -> resample 24k
        -> log-mel -> speaker encoder)."""
        self._require_ready()
        if not self.has_speaker_encoder():
            raise EngineError("model has no speaker encoder")
        audio, sr = read_wav(wav_path)
        if sr != SAMPLE_RATE:
            audio = resample(audio, sr, SAMPLE_RATE)
        mel = log_mel(audio, self.cfg.mel)  # [T, 128]
        if self._spk_fn is None:
            se_cfg = self.cfg.speaker_encoder
            self._spk_fn = jax.jit(
                lambda p, m: speaker_encoder_forward(se_cfg, p, m)
            )
        emb = self._spk_fn(self.params["speaker_encoder"], mel[None])
        return np.asarray(emb[0], np.float32)

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------

    @staticmethod
    def _kw_to_sampling(kw: dict) -> dict:
        out = dict(
            temperature=kw.pop("temperature", 0.8),
            top_k=kw.pop("top_k", 50),
            top_p=kw.pop("top_p", 0.95),
            max_tokens=kw.pop("max_tokens", None),
            seed=kw.pop("seed", 0),
            instruct=kw.pop("instruct", None),
        )
        if kw:
            raise TypeError(f"unknown arguments: {sorted(kw)}")
        return out

    def _require_ready(self):
        if not self._ready:
            raise EngineError(f"engine not ready: {self._error}")

    def _tokenize(self, text: str) -> List[int]:
        if self.tokenizer is None:
            raise EngineError(
                "tokenizer not loaded (missing vocab.json/merges.txt)"
            )  # reference refuses likewise, tts_onnx.cpp:253-255
        ids = self.tokenizer.encode(text)
        if not ids:
            raise EngineError("empty text")
        return ids

    def _get_fns(self, batch: int, t_bucket: int, lang_id, has_speaker: bool,
                 kv_bucket: Optional[int] = None, i_bucket: int = 0,
                 chunk_len: Optional[int] = None):
        kv_bucket = self.kv_ladder[-1] if kv_bucket is None else kv_bucket
        chunk_len = self.chunk_len if chunk_len is None else chunk_len
        key = (batch, t_bucket, lang_id, has_speaker, kv_bucket, i_bucket, chunk_len)
        if key not in self._fns_cache:
            self._fns_cache[key] = make_generate_fns(
                self.cfg,
                batch=batch,
                max_len=kv_bucket,
                chunk_len=chunk_len,
                lang_id=lang_id,
                has_speaker=has_speaker,
                has_instruct=i_bucket > 0,
            )
        return self._fns_cache[key]

    @staticmethod
    def _grow_state(state, new_len: int):
        """Zero-pad the KV cache (head-major time axis) and validity mask up
        to the next bucket; padded slots are invalid until written."""
        pad = new_len - state.cache.k.shape[3]
        widen = ((0, 0), (0, 0), (0, 0), (0, pad), (0, 0))
        cache = state.cache._replace(
            k=jnp.pad(state.cache.k, widen),
            v=jnp.pad(state.cache.v, widen),
        )
        if state.cache.k_scale is not None:
            cache = cache._replace(
                k_scale=jnp.pad(state.cache.k_scale, widen[:-1]),
                v_scale=jnp.pad(state.cache.v_scale, widen[:-1]),
            )
        valid = jnp.pad(state.valid_mask, ((0, 0), (0, pad)))
        return state._replace(cache=cache, valid_mask=valid)

    def _get_vocode_fn(self, n_frames: int, context: int) -> Callable:
        key = (n_frames, context)
        if key not in self._vocode_cache:
            voc_cfg = self.cfg.vocoder

            def impl(params, codes):
                audio = vocoder_forward(voc_cfg, params, codes)
                return audio[:, context * voc_cfg.samples_per_frame :]

            self._vocode_cache[key] = jax.jit(impl)
        return self._vocode_cache[key]

    def _get_spec_fns(self, t_bucket: int, lang_id, has_speaker: bool,
                      max_len: int, i_bucket: int, num_iters: int,
                      batch: int = 1):
        from ..runtime.speculative import make_spec_generate_fns, repeat_draft

        use_model_draft = (
            self.cfg.draft is not None and "draft" in (self.params or {})
        )
        key = ("spec", batch, t_bucket, lang_id, has_speaker, max_len,
               i_bucket, self.spec_k, num_iters, use_model_draft)
        if key not in self._fns_cache:
            if use_model_draft:
                # trained EAGLE-style draft head (models/draft.py) beats the
                # zero-cost repeat draft whenever the checkpoint ships one
                from ..models.draft import model_draft_fn

                draft_fn = model_draft_fn(
                    self.cfg.draft, self.params["draft"],
                    self.params["embeddings"],
                )
            else:
                draft_fn = repeat_draft
            self._fns_cache[key] = make_spec_generate_fns(
                self.cfg, max_len=max_len, k=self.spec_k,
                num_iters=num_iters, batch=batch, lang_id=lang_id,
                has_speaker=has_speaker, has_instruct=i_bucket > 0,
                draft_fn=draft_fn,
            )
        return self._fns_cache[key]

    def _spec_prologue(self, P: int, max_tokens: int):
        """Shared setup for both spec streams: shrink iterations-per-dispatch
        to fit short requests / small KV budgets (each dispatch can consume
        up to k * iters cache slots), clamp max_tokens to the bucket budget,
        pick the starting ladder rung.  Returns (iters, spec_chunk,
        max_tokens, bidx)."""
        top = self.kv_ladder[-1]
        iters = min(self.spec_iters, max(1, -(-max_tokens // self.spec_k)))
        while self.spec_k * iters > top - P - 1 and iters > 1:
            iters -= 1
        spec_chunk = self.spec_k * iters
        budget = top - P - spec_chunk
        if budget < 1:
            raise EngineError(
                f"prompt ({P} positions) too long for the KV cache "
                f"(top bucket {top}, spec chunk {spec_chunk})"
            )
        bidx = next(
            (i for i, b in enumerate(self.kv_ladder) if b >= P + spec_chunk + 1),
            len(self.kv_ladder) - 1,
        )
        return iters, spec_chunk, min(max_tokens, budget), bidx

    def _spec_stream(
        self, timer, ids_padded, lens, speaker, instr_arr, instr_len,
        t_bucket, lang_id, has_speaker, i_bucket, P, max_tokens, sp, key,
    ):
        """Speculative-decode variant of the stream loop (B=1 only).

        Commits per dispatch are data-dependent (between spec_iters and
        spec_iters*spec_k frames), so frames are compacted on the host and
        vocoded in fixed-size windows; audio/codes/metrics semantics match
        the sequential path.
        """
        voc_cfg = self.cfg.vocoder
        spf = voc_cfg.samples_per_frame
        iters, spec_chunk, max_tokens, bidx = self._spec_prologue(P, max_tokens)
        # TTFA ramp: the first dispatch runs a single verify iteration so
        # first audio lands after ~1 iteration instead of `iters`; steady
        # state uses the full count (ladder math stays sized for the max)
        cur_iters = 1 if iters > 1 else iters
        fns = self._get_spec_fns(
            t_bucket, lang_id, has_speaker, self.kv_ladder[bidx], i_bucket,
            cur_iters,
        )

        with timer.stage("prefill"):
            state, bundle, frame0, valid0 = fns.prefill(
                self.params,
                ids_padded,
                lens,
                key,
                sp,
                jnp.asarray(speaker) if speaker is not None else None,
                jnp.asarray(instr_arr) if instr_arr is not None else None,
                jnp.asarray(instr_len) if instr_len is not None else None,
            )
            jax.block_until_ready(frame0)

        committed: List[np.ndarray] = []  # [16] rows, valid frames in order
        if bool(np.asarray(valid0)[0]):
            committed.append(np.asarray(frame0)[0])
        done = bool(np.asarray(state.done).all())
        slots = 1  # inputs consumed so far == state.step mirror
        n_iterations = 0  # verify iterations run (acceptance accounting)

        emitted = 0  # frames already vocoded + yielded
        tail: Optional[np.ndarray] = None  # [1, ctx, 16] vocoder context
        audio_chunks: List[np.ndarray] = []
        first = True

        def vocode(frames_np):
            # frames_np [n, 16] -> audio [n * spf] with causal left context
            nonlocal tail
            window = (
                frames_np[None]
                if tail is None
                else np.concatenate([tail, frames_np[None]], axis=1)
            )
            n_ctx = 0 if tail is None else tail.shape[1]
            vf = self._get_vocode_fn(int(window.shape[1]), n_ctx)
            audio = np.asarray(
                vf(self.params["vocoder"], jnp.asarray(window)), np.float32
            )
            ctx = min(voc_cfg.left_context_frames, window.shape[1])
            tail = window[:, window.shape[1] - ctx :]
            return audio[0]

        while True:
            # emit ready audio in fixed windows (first window small for TTFA)
            want = self.first_chunk_len if first else self.chunk_len
            while len(committed) - emitted >= want and emitted < max_tokens:
                n = min(want, max_tokens - emitted)
                with timer.stage("vocode"):
                    audio = vocode(
                        np.stack(committed[emitted : emitted + n], axis=0)
                    )
                audio_chunks.append(audio)
                emitted += n
                timer.mark_first_audio()
                first = False
                want = self.chunk_len
                yield audio

            if done or len(committed) >= max_tokens:
                break
            while (
                P + slots - 1 + spec_chunk + 1 > self.kv_ladder[bidx]
                and bidx + 1 < len(self.kv_ladder)
            ):
                bidx += 1
                state = self._grow_state(state, self.kv_ladder[bidx])
                fns = self._get_spec_fns(
                    t_bucket, lang_id, has_speaker, self.kv_ladder[bidx],
                    i_bucket, cur_iters,
                )
            if P + slots - 1 + spec_chunk + 1 > self.kv_ladder[bidx]:
                break  # KV budget exhausted (max_tokens clamp makes this rare)
            with timer.stage("decode"):
                state, frames, valid = fns.decode(
                    self.params, state, bundle.trailing, bundle.trailing_len,
                    bundle.tts_pad_embed, sp,
                )
                frames_np = np.asarray(frames)[0]  # [iters*k, 16]
            valid_np = np.asarray(valid)[0]
            committed.extend(frames_np[valid_np])
            done = bool(np.asarray(state.done).all())
            slots = int(np.asarray(state.step)[0])
            n_iterations += cur_iters
            if cur_iters != iters:
                cur_iters = iters
                fns = self._get_spec_fns(
                    t_bucket, lang_id, has_speaker, self.kv_ladder[bidx],
                    i_bucket, cur_iters,
                )

            # --- adaptive fallback: trailing acceptance too low for spec to
            # pay for itself -> consume the pending input once and continue
            # on the sequential loop (greedy output is unchanged: both paths
            # sample the same per-frame conditionals)
            if (
                not done
                and self.spec_accept_floor > 0
                and n_iterations >= self.spec_adapt_window
            ):
                accept = (slots - 1 - n_iterations) / max(
                    n_iterations * (self.spec_k - 1), 1
                )
                if accept < self.spec_accept_floor:
                    log.info(
                        "spec acceptance %.2f < floor %.2f after %d "
                        "iterations; reverting to sequential decode",
                        accept, self.spec_accept_floor, n_iterations,
                    )
                    yield from self._spec_seq_continue(
                        timer, state, bundle, committed, emitted,
                        audio_chunks, vocode, max_tokens, sp, t_bucket,
                        lang_id, has_speaker, i_bucket, bidx, n_iterations,
                        slots, spf,
                    )
                    return

        # final partial window
        if emitted < min(len(committed), max_tokens):
            n = min(len(committed), max_tokens) - emitted
            with timer.stage("vocode"):
                audio = vocode(np.stack(committed[emitted : emitted + n], axis=0))
            audio_chunks.append(audio)
            emitted += n
            timer.mark_first_audio()
            yield audio

        codes = (
            np.stack(committed[:emitted], axis=0)
            if emitted
            else np.zeros((0, 16), np.int32)
        )
        full_audio = (
            np.concatenate(audio_chunks) if audio_chunks else np.zeros((0,), np.float32)
        )
        metrics = timer.finish()
        metrics.frames = emitted
        metrics.audio_seconds = emitted * spf / SAMPLE_RATE
        metrics.spec_iterations = n_iterations
        # each iteration commits 1 + accepted-drafts slots (slots counts the
        # bootstrap frame too)
        metrics.spec_accepted = max(0, (slots - 1) - n_iterations)
        yield SynthesisResult(audio=full_audio, codes=codes, metrics=metrics)

    def _spec_seq_continue(
        self, timer, spec_state, bundle, committed, emitted, audio_chunks,
        vocode, max_tokens, sp, t_bucket, lang_id, has_speaker, i_bucket,
        bidx, n_iterations, slots, spf,
    ):
        """Sequential continuation after the adaptive-spec fallback: convert
        the SpecState (one talker step consuming the pending input), then run
        the plain chunked loop to completion."""
        from ..runtime.speculative import spec_to_seq

        ckey = ("spec2seq", self.kv_ladder[bidx])
        if ckey not in self._fns_cache:
            cfg = self.cfg
            self._fns_cache[ckey] = jax.jit(
                lambda p, s, tr, tl, pad: spec_to_seq(cfg, p, s, tr, tl, pad)
            )
        state = self._fns_cache[ckey](
            self.params, spec_state, bundle.trailing, bundle.trailing_len,
            bundle.tts_pad_embed,
        )
        pos = int(np.asarray(state.pos)[0])
        while len(committed) < max_tokens:
            cur_chunk = self.chunk_len
            while (
                pos + cur_chunk + 1 > self.kv_ladder[bidx]
                and bidx + 1 < len(self.kv_ladder)
            ):
                bidx += 1
                state = self._grow_state(state, self.kv_ladder[bidx])
            if pos + cur_chunk + 1 > self.kv_ladder[bidx]:
                break
            fns = self._get_fns(
                1, t_bucket, lang_id, has_speaker, self.kv_ladder[bidx],
                i_bucket, cur_chunk,
            )
            with timer.stage("decode"):
                state, frames, valid = fns.decode(
                    self.params, state, bundle.trailing, bundle.trailing_len,
                    bundle.tts_pad_embed, sp,
                )
                frames_np = np.asarray(frames)[0]
            valid_np = np.asarray(valid)[0]
            committed.extend(frames_np[valid_np])
            pos += cur_chunk
            while (
                len(committed) - emitted >= self.chunk_len
                and emitted < max_tokens
            ):
                n = min(self.chunk_len, max_tokens - emitted)
                with timer.stage("vocode"):
                    audio = vocode(
                        np.stack(committed[emitted : emitted + n], axis=0)
                    )
                audio_chunks.append(audio)
                emitted += n
                timer.mark_first_audio()
                yield audio
            if bool(np.asarray(state.done).all()):
                break

        if emitted < min(len(committed), max_tokens):
            n = min(len(committed), max_tokens) - emitted
            with timer.stage("vocode"):
                audio = vocode(np.stack(committed[emitted : emitted + n], axis=0))
            audio_chunks.append(audio)
            emitted += n
            timer.mark_first_audio()
            yield audio

        codes = (
            np.stack(committed[:emitted], axis=0)
            if emitted
            else np.zeros((0, 16), np.int32)
        )
        full_audio = (
            np.concatenate(audio_chunks)
            if audio_chunks
            else np.zeros((0,), np.float32)
        )
        metrics = timer.finish()
        metrics.frames = emitted
        metrics.audio_seconds = emitted * spf / SAMPLE_RATE
        metrics.spec_iterations = n_iterations
        metrics.spec_accepted = max(0, (slots - 1) - n_iterations)
        metrics.spec_fallback = True
        yield SynthesisResult(audio=full_audio, codes=codes, metrics=metrics)

    def _spec_stream_batched(
        self, timer, B, ids_padded, lens, speaker, instr_arr, instr_len,
        t_bucket, lang_id, has_speaker, i_bucket, P, max_tokens, sp, key,
    ):
        """Batched speculative decode (B > 1): one S=K verify pass covers
        B*K frame slots with PER-STREAM acceptance/rewinds.  Streams commit
        at independent rates, so frames compact per stream on the host and
        the vocoder runs once at the end on the padded batch (no
        intermediate audio yields — synthesize_batch consumes only the final
        result; the <150 ms TTFA path is the B=1 stream)."""
        voc_cfg = self.cfg.vocoder
        spf = voc_cfg.samples_per_frame
        iters, spec_chunk, max_tokens, bidx = self._spec_prologue(P, max_tokens)

        def get_fns(bucket):
            return self._get_spec_fns(
                t_bucket, lang_id, has_speaker, bucket, i_bucket, iters,
                batch=B,
            )

        fns = get_fns(self.kv_ladder[bidx])
        with timer.stage("prefill"):
            state, bundle, frame0, valid0 = fns.prefill(
                self.params, ids_padded, lens, key, sp,
                jnp.asarray(speaker) if speaker is not None else None,
                jnp.asarray(instr_arr) if instr_arr is not None else None,
                jnp.asarray(instr_len) if instr_len is not None else None,
            )
            jax.block_until_ready(frame0)

        buffers = [[] for _ in range(B)]
        f0, v0 = np.asarray(frame0), np.asarray(valid0)
        for b in range(B):
            if v0[b]:
                buffers[b].append(f0[b])
        done = np.asarray(state.done).copy()
        steps = np.ones((B,), np.int64)
        n_iterations = 0
        while True:
            if bool(done.all()):
                break
            if all(len(buf) >= max_tokens for buf in buffers):
                break
            slots = int(steps.max())
            while (
                P + slots - 1 + spec_chunk + 1 > self.kv_ladder[bidx]
                and bidx + 1 < len(self.kv_ladder)
            ):
                bidx += 1
                state = self._grow_state(state, self.kv_ladder[bidx])
                fns = get_fns(self.kv_ladder[bidx])
            if P + slots - 1 + spec_chunk + 1 > self.kv_ladder[bidx]:
                break
            with timer.stage("decode"):
                state, frames, valid = fns.decode(
                    self.params, state, bundle.trailing, bundle.trailing_len,
                    bundle.tts_pad_embed, sp,
                )
                frames_np = np.asarray(frames)  # [B, iters*k, 16]
            valid_np = np.asarray(valid)
            for b in range(B):
                buffers[b].extend(frames_np[b][valid_np[b]])
            done = np.asarray(state.done).copy()
            steps = np.asarray(state.step).astype(np.int64)
            n_iterations += iters

        n_valid = np.array(
            [min(len(buf), max_tokens) for buf in buffers], np.int64
        )
        F_max = max(int(n_valid.max()), 1)
        F_pad = -(-F_max // self.chunk_len) * self.chunk_len  # bound compiles
        codes_arr = np.zeros((B, F_pad, 16), np.int32)
        for b in range(B):
            if n_valid[b]:
                codes_arr[b, : n_valid[b]] = np.stack(
                    buffers[b][: n_valid[b]], axis=0
                )
        with timer.stage("vocode"):
            vf = self._get_vocode_fn(F_pad, 0)
            audio = np.asarray(
                vf(self.params["vocoder"], jnp.asarray(codes_arr)), np.float32
            )
        timer.mark_first_audio()
        metrics = timer.finish()
        per_stream = []
        for b in range(B):
            m = SynthesisMetrics(
                stage_seconds=dict(metrics.stage_seconds),
                audio_seconds=float(n_valid[b]) * spf / SAMPLE_RATE,
                frames=int(n_valid[b]),
                ttfa_seconds=metrics.ttfa_seconds,
                total_seconds=metrics.total_seconds,
                spec_iterations=n_iterations,
                spec_accepted=max(0, int(steps[b]) - 1 - n_iterations),
            )
            per_stream.append(m)
        yield SynthesisResult(
            audio=[audio[b, : int(n_valid[b]) * spf] for b in range(B)],
            codes=[codes_arr[b, : n_valid[b]] for b in range(B)],
            metrics=per_stream,
        )

    def _synthesize_stream(
        self, texts, language, speaker, temperature, top_k, top_p, max_tokens, seed,
        instruct=None, streaming=False,
    ):
        self._require_ready()
        timer = StageTimer(SynthesisMetrics())
        with timer.stage("tokenize"):
            id_lists = [self._tokenize(t) for t in texts]
            instruct_ids = self._tokenize(instruct) if instruct else None
        yield from self._ids_stream(
            id_lists, language, speaker, temperature, top_k, top_p, max_tokens, seed,
            timer, instruct_ids=instruct_ids, streaming=streaming,
        )

    def _synthesize_ids_stream(
        self, id_lists, language, speaker, temperature, top_k, top_p, max_tokens, seed
    ):
        self._require_ready()
        timer = StageTimer(SynthesisMetrics())
        yield from self._ids_stream(
            id_lists, language, speaker, temperature, top_k, top_p, max_tokens, seed, timer
        )

    def _ids_stream(
        self, id_lists, language, speaker, temperature, top_k, top_p, max_tokens, seed,
        timer, instruct_ids=None, streaming=False,
    ):
        with maybe_trace("synthesize"):
            yield from self._ids_stream_impl(
                id_lists, language, speaker, temperature, top_k, top_p, max_tokens, seed,
                timer, instruct_ids, streaming,
            )

    def _ids_stream_impl(
        self, id_lists, language, speaker, temperature, top_k, top_p, max_tokens, seed,
        timer, instruct_ids=None, streaming=False,
    ):
        cfg = self.cfg
        B = len(id_lists)
        # Out-of-range ids would gather NaN embeddings (jnp.take fill) and
        # surface as silent NaN audio; fail typed at the boundary instead.
        vocab = cfg.talker.text_vocab_size
        for ids in list(id_lists) + ([instruct_ids] if instruct_ids else []):
            bad = [i for i in ids if not 0 <= int(i) < vocab]
            if bad:
                raise EngineError(
                    f"token id(s) out of range [0, {vocab}): {bad[:8]}"
                )
        lang_id = language_to_codec_id(language if language != "auto" else None)
        max_tokens = self.max_frames if max_tokens is None else min(max_tokens, self.max_frames)

        lens = np.array([len(ids) for ids in id_lists], np.int32)
        t_bucket = _round_up(int(lens.max()), self.text_bucket)
        ids_padded = np.zeros((B, t_bucket), np.int32)
        for b, ids in enumerate(id_lists):
            ids_padded[b, : len(ids)] = ids

        if self.mesh is not None:
            # shard the request batch over the "data" axis when it divides
            from jax.sharding import NamedSharding, PartitionSpec as P

            data_size = self.mesh.shape.get("data", 1)
            spec = P("data") if B % data_size == 0 else P()
            s = NamedSharding(self.mesh, spec)
            ids_padded = jax.device_put(ids_padded, s)
            lens = jax.device_put(lens, s)

        has_speaker = speaker is not None
        from ..runtime.prompt import prompt_length

        if instruct_ids:
            i_bucket = _round_up(len(instruct_ids), self.text_bucket)
            instr_arr = np.zeros((B, i_bucket), np.int32)
            instr_arr[:, : len(instruct_ids)] = instruct_ids
            instr_len = np.full((B,), len(instruct_ids), np.int32)
        else:
            i_bucket, instr_arr, instr_len = 0, None, None

        P = prompt_length(lang_id, has_speaker, i_bucket)
        # Cap generation so the KV write position can never pass the top
        # bucket: the last chunk may overshoot max_tokens by up to
        # chunk_len-1 frames (trimmed after the loop), so the budget reserves
        # a full chunk below the top.  Without this, long-form + instruct
        # requests ran the ladder off its end (round-1 advisor finding).
        top = self.kv_ladder[-1]
        budget = top - P - self.chunk_len
        if budget < 1:
            raise EngineError(
                f"prompt ({P} positions) too long for the KV cache "
                f"(top bucket {top}, chunk {self.chunk_len})"
            )
        max_tokens = min(max_tokens, budget)
        bidx = next(
            (i for i, b in enumerate(self.kv_ladder) if b >= P + self.chunk_len + 1),
            len(self.kv_ladder) - 1,
        )
        sp = SamplingParams.create(temperature, top_k, top_p)
        if isinstance(seed, (list, tuple, np.ndarray)):
            # per-stream seeds: [B, 2] per-row PRNG chains (each stream's
            # draws depend only on its own seed — runtime/sampling.split_keys)
            if len(seed) != B:
                raise EngineError(
                    f"seed sequence length {len(seed)} != batch {B}"
                )
            key = jnp.stack([jax.random.PRNGKey(int(s)) for s in seed])
        else:
            key = jax.random.PRNGKey(seed)

        # Batched spec decode yields no incremental audio (frames compact per
        # stream; one final vocode) — a STREAMING caller at B > 1 keeps the
        # per-chunk contract via the sequential path instead (round-2 advisor
        # finding); spec batching stays the synthesize_batch fast path.
        if self.spec_k is not None and not (streaming and B > 1):
            # works sharded too: the S=K verify pass is a plain
            # transformer_forward, so the TP rules/GSPMD collectives apply
            # unchanged (tested on the 8-virtual-CPU mesh)
            if B == 1:
                yield from self._spec_stream(
                    timer, ids_padded, lens, speaker, instr_arr, instr_len,
                    t_bucket, lang_id, has_speaker, i_bucket, P, max_tokens,
                    sp, key,
                )
            else:
                yield from self._spec_stream_batched(
                    timer, B, ids_padded, lens, speaker, instr_arr,
                    instr_len, t_bucket, lang_id, has_speaker, i_bucket, P,
                    max_tokens, sp, key,
                )
            return

        fns = self._get_fns(
            B, t_bucket, lang_id, has_speaker, self.kv_ladder[bidx], i_bucket
        )

        with timer.stage("prefill"):
            state, bundle = fns.prefill(
                self.params,
                ids_padded,
                lens,
                key,
                jnp.asarray(speaker) if has_speaker else None,
                jnp.asarray(instr_arr) if instr_arr is not None else None,
                jnp.asarray(instr_len) if instr_len is not None else None,
            )
            jax.block_until_ready(state.last_logits)

        voc_cfg = cfg.vocoder
        spf = voc_cfg.samples_per_frame
        frames_chunks: List[np.ndarray] = []
        valid_chunks: List[np.ndarray] = []
        audio_chunks: List[np.ndarray] = []
        tail: Optional[jax.Array] = None  # rolling [B, ctx, 16] vocoder context
        steps = 0
        first = True
        while steps < max_tokens:
            cur_chunk = self.first_chunk_len if first else self.chunk_len
            while (
                P + steps + cur_chunk + 1 > self.kv_ladder[bidx]
                and bidx + 1 < len(self.kv_ladder)
            ):
                bidx += 1  # grow the cache into the next bucket
                state = self._grow_state(state, self.kv_ladder[bidx])
            cur_fns = self._get_fns(
                B, t_bucket, lang_id, has_speaker, self.kv_ladder[bidx],
                i_bucket, cur_chunk,
            )
            with timer.stage("decode"):
                state, frames, valid = cur_fns.decode(
                    self.params,
                    state,
                    bundle.trailing,
                    bundle.trailing_len,
                    bundle.tts_pad_embed,
                    sp,
                )
                frames = jax.block_until_ready(frames)
            valid_np = np.asarray(valid)
            frames_chunks.append(np.asarray(frames))
            valid_chunks.append(valid_np)
            steps += cur_chunk

            # streaming vocode of this chunk (causal left context -> exact)
            with timer.stage("vocode"):
                if tail is None:
                    window, n_ctx = frames, 0
                else:
                    n_ctx = int(tail.shape[1])
                    window = jnp.concatenate([tail, frames], axis=1)
                vf = self._get_vocode_fn(int(window.shape[1]), n_ctx)
                audio = np.asarray(vf(self.params["vocoder"], window), np.float32)
                all_so_far = (
                    frames if tail is None
                    else jnp.concatenate([tail, frames], axis=1)
                )
                ctx = min(voc_cfg.left_context_frames, int(all_so_far.shape[1]))
                tail = all_so_far[:, all_so_far.shape[1] - ctx :]
            # zero out samples of invalid (post-EOS) frames
            mask = np.repeat(valid_np, spf, axis=1)
            audio = audio * mask
            audio_chunks.append(audio)
            timer.mark_first_audio()
            first = False
            # the last chunk may overshoot max_tokens: cap the STREAMED
            # audio so consumers never hear frames the final result trims
            keep = min(cur_chunk, max_tokens - (steps - cur_chunk)) * spf
            emit = audio[:, :keep]
            yield emit[0] if B == 1 else emit

            if bool(np.asarray(state.done).all()):
                break

        # trim to max_tokens (the last chunk may overshoot when max_tokens is
        # not a multiple of chunk_len)
        all_frames = np.concatenate(frames_chunks, axis=1)[:, :max_tokens]  # [B, F, 16]
        all_valid = np.concatenate(valid_chunks, axis=1)[:, :max_tokens]  # [B, F]
        n_valid = all_valid.sum(axis=1)  # frames before EOS per stream
        full_audio = np.concatenate(audio_chunks, axis=1)  # [B, F * spf]

        metrics = timer.finish()
        metrics.frames = int(n_valid.max()) if B else 0
        metrics.audio_seconds = float(n_valid.max()) * spf / SAMPLE_RATE

        if B == 1:
            n = int(n_valid[0]) * spf
            yield SynthesisResult(
                audio=full_audio[0, :n],
                codes=all_frames[0][all_valid[0]],
                metrics=metrics,
            )
        else:
            # per-stream frame/audio counts (stage wall-clock is shared: the
            # whole batch decodes as one SPMD program, so per-request RTF is
            # that stream's audio over the batch's wall time)
            per_stream = []
            for b in range(B):
                m = SynthesisMetrics(
                    stage_seconds=dict(metrics.stage_seconds),
                    audio_seconds=float(n_valid[b]) * spf / SAMPLE_RATE,
                    frames=int(n_valid[b]),
                    ttfa_seconds=metrics.ttfa_seconds,
                    total_seconds=metrics.total_seconds,
                )
                per_stream.append(m)
            yield SynthesisResult(
                audio=[full_audio[b, : int(n_valid[b]) * spf] for b in range(B)],
                codes=[all_frames[b][all_valid[b]] for b in range(B)],
                metrics=per_stream,
            )
