"""Tokenizer tests: hand-computed BPE, native/Python cross-check, HF oracle,
and the reference repo's 5 committed ground-truth pairs (when real vocab
assets are present).  Mirrors the reference's test strategy
(tests/test_tokenizer_real.cpp fixtures + tests/test_tokenizer.cpp sanity)."""

import json
import os

import pytest

from leaxer_qwen3_tts_tpu.frontend._bpe_py import (
    PyBpeTokenizer,
    byte_to_proxy,
    pretokenize_qwen2,
)
from leaxer_qwen3_tts_tpu.frontend.tokenizer import Tokenizer
from leaxer_qwen3_tts_tpu.frontend import native as qtts_native

CORPUS = [
    "hello",
    "hello world",
    "Hello, World!",
    "I'm sure it's fine, we're ok, you've said they'll go, he'd know.",
    "hello   world",
    "a\nb",
    "\n\n x",
    "tabs\there and\tthere",
    "123 4567 0",
    "price: $5.99!?",
    "你好世界",
    "こんにちは、元気ですか",
    "한국어 테스트 문장입니다",
    "mixed 你好 world 123 テスト",
    "'S 'T WEIRD 'RE",
    "trailing space ",
    " leading",
    "emoji 😀 test",
    "a\r\nb\r\n\r\n",
    "  \n  ",
    "１２３ fullwidth",
    "under_score and-dash",
    "",
]


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    """Synthetic vocab.json/merges.txt: full byte alphabet + composed merges."""
    proxy = byte_to_proxy()
    tokens = [proxy[b] for b in range(256)]
    merges = []

    def add(a, b):
        merges.append((a, b))
        if a + b not in tokens:
            tokens.append(a + b)

    # "hello": h+e, l+l, he+ll, hell+o
    add("h", "e")
    add("l", "l")
    add("he", "ll")
    add("hell", "o")
    # " world": Ġ+w, o+r, Ġw+or, l+d, Ġwor+ld
    add("Ġ", "w")
    add("o", "r")
    add("Ġw", "or")
    add("l", "d")
    add("Ġwor", "ld")
    # CJK 你 (e4 bd a0) and 好 (e5 a5 bd) as single tokens
    for ch in ("你", "好"):
        bs = ch.encode("utf-8")
        a, b, c = proxy[bs[0]], proxy[bs[1]], proxy[bs[2]]
        add(a, b)
        add(a + b, c)
    # digit pair merge exercising \p{N}-single-digit pretokenization
    add("1", "2")
    # contraction merge
    add("'", "s")

    vocab = {t: i for i, t in enumerate(tokens)}
    vocab["😀"] = len(vocab)  # astral-plane key: exercises \uXXXX surrogate parsing

    d = tmp_path_factory.mktemp("tok")
    vocab_path = os.path.join(d, "vocab.json")
    merges_path = os.path.join(d, "merges.txt")
    with open(vocab_path, "w") as f:
        json.dump(vocab, f, ensure_ascii=True)  # \u escapes: exercises the parser
    with open(merges_path, "w") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return str(vocab_path), str(merges_path), vocab


def test_native_library_builds():
    assert qtts_native.native_available(), "native libqtts.so failed to build/load"


def _proxy_key(s: str) -> str:
    """Raw text -> its byte-proxy vocab key (identity for printable ASCII)."""
    proxy = byte_to_proxy()
    return "".join(proxy[b] for b in s.encode("utf-8"))


def test_hand_computed_merges(tiny_files):
    vocab_path, merges_path, vocab = tiny_files
    tok = Tokenizer(vocab_path, merges_path)
    assert tok.encode("hello") == [vocab["hello"]]
    assert tok.encode("hello world") == [vocab["hello"], vocab["Ġworld"]]
    # unmerged word falls back to byte-proxy tokens
    assert tok.encode("xyz") == [vocab["x"], vocab["y"], vocab["z"]]
    # CJK merged tokens via the qwen2 pre-tokenizer
    assert tok.encode("你好") == [vocab[_proxy_key("你")], vocab[_proxy_key("好")]]
    # single-digit pretokenization means "12" stays two tokens in qwen2 mode
    assert tok.encode("12") == [vocab["1"], vocab["2"]]
    assert tok.encode("it's") == [vocab["i"], vocab["t"], vocab["'s"]]


def test_reference_mode_digit_runs(tiny_files):
    vocab_path, merges_path, vocab = tiny_files
    # reference regex groups digit RUNS -> the 1+2 merge applies
    tok = Tokenizer(vocab_path, merges_path, mode="reference")
    assert tok.encode("12") == [vocab["12"]]


def test_native_matches_python_both_modes(tiny_files):
    vocab_path, merges_path, _ = tiny_files
    for mode in ("qwen2", "reference"):
        nat = Tokenizer(vocab_path, merges_path, mode=mode, backend="native")
        py = Tokenizer(vocab_path, merges_path, mode=mode, backend="python")
        assert nat.backend == "native" and py.backend == "python"
        for text in CORPUS:
            assert nat.encode(text) == py.encode(text), (mode, text)


def test_decode_roundtrip(tiny_files):
    vocab_path, merges_path, _ = tiny_files
    for backend in ("native", "python"):
        tok = Tokenizer(vocab_path, merges_path, backend=backend)
        for text in ["hello world", "你好", "I'm here", "a b  c"]:
            assert tok.decode(tok.encode(text)) == text, backend


def test_token_string_lookups(tiny_files):
    vocab_path, merges_path, vocab = tiny_files
    for backend in ("native", "python"):
        tok = Tokenizer(vocab_path, merges_path, backend=backend)
        assert tok.string_to_token("hello") == vocab["hello"]
        assert tok.token_to_string(vocab["hello"]) == "hello"
        assert tok.string_to_token("😀") == vocab["😀"]  # surrogate-pair JSON key
        assert tok.string_to_token("not-a-token") == -1
        assert tok.vocab_size == len(vocab)


def test_missing_vocab_raises(tmp_path):
    with pytest.raises(Exception):
        Tokenizer(str(tmp_path / "nope.json"), backend="python")
    lib = qtts_native.load_native()
    if lib is not None:
        with pytest.raises(RuntimeError):
            Tokenizer(str(tmp_path / "nope.json"), backend="native")


def test_pretokenize_qwen2_spans():
    # space attaches to the following word; multi-space leaves last for the word
    assert pretokenize_qwen2("hello world") == ["hello", " world"]
    assert pretokenize_qwen2("hello  world") == ["hello", " ", " world"]
    assert pretokenize_qwen2("it's") == ["it", "'s"]
    assert pretokenize_qwen2("a\nb") == ["a", "\n", "b"]
    assert pretokenize_qwen2("x1y") == ["x", "1", "y"]
    assert pretokenize_qwen2("hi!") == ["hi", "!"]
    assert pretokenize_qwen2(" !") == [" !"]


@pytest.fixture(scope="module")
def hf_oracle(tiny_files):
    """HF slow Qwen2 tokenizer over the same tiny vocab (true regex oracle)."""
    vocab_path, merges_path, _ = tiny_files
    try:
        from transformers.models.qwen2.tokenization_qwen2 import Qwen2Tokenizer
    except Exception:
        pytest.skip("transformers Qwen2Tokenizer unavailable")
    try:
        return Qwen2Tokenizer(
            vocab_file=vocab_path, merges_file=merges_path, unk_token=None
        )
    except Exception as e:  # pragma: no cover
        pytest.skip(f"Qwen2Tokenizer init failed: {e}")


def test_qwen2_mode_matches_hf(tiny_files, hf_oracle):
    vocab_path, merges_path, _ = tiny_files
    tok = Tokenizer(vocab_path, merges_path, mode="qwen2")
    for text in CORPUS:
        if not text:
            continue
        expected = hf_oracle.convert_tokens_to_ids(hf_oracle.tokenize(text))
        got = tok.encode(text)
        assert got == expected, text


# --- real-asset oracle (reference tests/fixtures ground truth) ---------------

# a directory holding the released Qwen3-TTS vocab.json / merges.txt
REAL_VOCAB_DIRS = [os.environ.get("QWEN3_TTS_VOCAB_DIR", "")]

# Ground truth recorded in SURVEY.md §4 from the reference's committed fixtures
# (tests/fixtures/tokenizer_test{0-4}.json).
REAL_CASES = [
    ("hello", [14990]),
    ("world", [14615]),
    ("speech", [88225]),
    ("synthesis", [20339, 13189]),
    ("testing", [8840]),
]


@pytest.mark.parametrize("text,expected", REAL_CASES)
def test_real_vocab_oracle(text, expected):
    for d in REAL_VOCAB_DIRS:
        if d and os.path.exists(os.path.join(d, "vocab.json")):
            tok = Tokenizer(
                os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")
            )
            assert tok.encode(text) == expected
            return
    pytest.skip("real Qwen3-TTS vocab assets not present")
