"""Serving-layer tests: dynamic batching, per-request sampling, HTTP facade."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from leaxer_qwen3_tts_tpu.api.engine import TTSEngine
from leaxer_qwen3_tts_tpu.frontend import Tokenizer
from leaxer_qwen3_tts_tpu.serve import BatchingServer, make_http_server, wav_bytes


@pytest.fixture(scope="module")
def engine(tiny_model, tiny_vocab_files):
    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    return TTSEngine(
        config=cfg,
        params=params,
        tokenizer=Tokenizer(vocab_path, merges_path),
        max_frames=6,
        chunk_len=3,
    )


@pytest.fixture()
def server(engine):
    s = BatchingServer(engine, max_batch=4, max_wait_ms=200.0)
    yield s
    s.shutdown()


def test_concurrent_requests_batch_together(server):
    futures = [
        server.submit("hello world", temperature=0.0),
        server.submit("hello", temperature=0.0),
        server.submit("hello world", temperature=0.0),
    ]
    results = [f.result(timeout=300) for f in futures]
    for r in results:
        assert r.audio.dtype == np.float32
        assert r.codes.shape[1] == 16
    # identical requests in one batch produce identical outputs
    np.testing.assert_array_equal(results[0].codes, results[2].codes)
    assert server.stats["requests"] == 3
    assert server.stats["batches"] <= 2  # grouped, not one-by-one


def test_batched_matches_solo_greedy(server, engine):
    batched = server.submit("hello world", temperature=0.0).result(timeout=300)
    solo = engine.synthesize("hello world", temperature=0.0)
    np.testing.assert_array_equal(batched.codes, solo.codes)


def test_per_request_sampling_in_one_batch(server):
    # one greedy + one high-temperature request, submitted together: the [B]
    # sampling vectors must keep them independent
    f1 = server.submit("hello world", temperature=0.0)
    f2 = server.submit("hello world", temperature=1.5, top_k=30)
    r1, r2 = f1.result(timeout=300), f2.result(timeout=300)
    assert (r1.codes.shape != r2.codes.shape) or not np.array_equal(
        r1.codes, r2.codes
    )


def test_wav_bytes_roundtrip(tmp_path):
    from leaxer_qwen3_tts_tpu.frontend import read_wav

    audio = np.sin(np.linspace(0, 50, 2000)).astype(np.float32) * 0.5
    data = wav_bytes(audio)
    p = tmp_path / "x.wav"
    p.write_bytes(data)
    back, sr = read_wav(str(p))
    assert sr == 24000
    np.testing.assert_allclose(back, audio, atol=2.0 / 32768.0)


def test_http_facade(server):
    httpd = make_http_server(server, "127.0.0.1", 0)  # ephemeral port
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            health = json.loads(r.read())
        assert health["ok"] is True

        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/synthesize",
            data=json.dumps({"text": "hello", "temperature": 0.0}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            body = r.read()
        assert body[:4] == b"RIFF"

        bad = urllib.request.Request(
            f"http://127.0.0.1:{port}/synthesize", data=b"not json"
        )
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(bad, timeout=60)

        # /synthesize_stream needs the continuous pool (submit_stream); the
        # static batcher advertises that instead of running a private decode
        sreq = urllib.request.Request(
            f"http://127.0.0.1:{port}/synthesize_stream",
            data=json.dumps({"text": "hello", "temperature": 0.0}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(sreq, timeout=60)
        assert e.value.code == 501
    finally:
        httpd.shutdown()


def test_server_over_mesh_engine(tiny_model, tiny_vocab_files):
    """The batching server composes with a TP+DP-sharded engine (the
    multi-device serving shape, here on the virtual CPU mesh)."""
    import jax

    from leaxer_qwen3_tts_tpu.parallel import make_mesh

    cfg, params = tiny_model
    vocab_path, merges_path, _ = tiny_vocab_files
    mesh = make_mesh(2, 4)
    with jax.set_mesh(mesh):
        eng = TTSEngine(
            config=cfg,
            params=params,
            tokenizer=Tokenizer(vocab_path, merges_path),
            max_frames=4,
            chunk_len=2,
            mesh=mesh,
        )
        s = BatchingServer(eng, max_batch=2, max_wait_ms=200.0)
        try:
            futs = [
                s.submit("hello", temperature=0.0),
                s.submit("hello world", temperature=0.0),
            ]
            results = [f.result(timeout=300) for f in futs]
        finally:
            s.shutdown()
    for r in results:
        assert r.codes.shape[1] == 16
        assert np.isfinite(r.audio).all()


def test_per_request_max_tokens_trimmed(server):
    """A request's own max_tokens bounds ITS result even when batch-mates ask
    for more (the batch runs with the max; round-1 advisor finding)."""
    f_short = server.submit("hello world", temperature=0.0, max_tokens=1)
    f_long = server.submit("hello world", temperature=0.0, max_tokens=6)
    short, long_ = f_short.result(timeout=300), f_long.result(timeout=300)
    assert short.codes.shape[0] <= 1
    assert short.audio.size == short.codes.shape[0] * 2000
    assert short.metrics.frames == short.codes.shape[0]
    assert long_.codes.shape[0] >= short.codes.shape[0]


