"""Test env: force the CPU backend with 8 virtual devices so sharding tests
run anywhere.  What only runs on the GPU is checked by chip_smoke.py (tests
that need the card carry the ``gpu`` marker and skip here).

Must run before jax is imported anywhere in the test process.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force: the shell may preset another
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# jax may be pre-imported by site startup with another platform latched; the
# config update (not the env var) is what reliably forces CPU here.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

from leaxer_qwen3_tts_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.5)
# Numerical tests compare different program shapes; pin full-f32 matmuls so the
# comparisons measure logic, not DEFAULT-precision (bf16-pass) reassociation.
jax.config.update("jax_default_matmul_precision", "highest")

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked ``gpu``; skips where there is none.

    Decided inside the fixture, never at import or collection time, so every
    test worker collects the same tests."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")
    return devices[0]


@pytest.fixture(scope="session")
def tiny_model():
    """Session-scoped tiny model (config, params) for fast integration tests.
    Built by conftest_util so the regression-fixture generator uses exactly
    the same model."""
    import jax as _jax

    from conftest_util import build_tiny

    return build_tiny(_jax)


@pytest.fixture(scope="session")
def tiny_vocab_files(tmp_path_factory):
    """Tiny vocab.json/merges.txt shared by tokenizer/engine/CLI tests."""
    import json

    from leaxer_qwen3_tts_tpu.frontend._bpe_py import byte_to_proxy

    proxy = byte_to_proxy()
    tokens = [proxy[b] for b in range(256)]
    merges = []

    def add(a, b):
        merges.append((a, b))
        if a + b not in tokens:
            tokens.append(a + b)

    for pair in [
        ("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"),
        ("Ġ", "w"), ("o", "r"), ("Ġw", "or"), ("l", "d"), ("Ġwor", "ld"),
    ]:
        add(*pair)
    vocab = {t: i for i, t in enumerate(tokens)}

    d = tmp_path_factory.mktemp("vocab")
    vocab_path = str(d / "vocab.json")
    merges_path = str(d / "merges.txt")
    with open(vocab_path, "w") as f:
        json.dump(vocab, f, ensure_ascii=True)
    with open(merges_path, "w") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return vocab_path, merges_path, vocab
