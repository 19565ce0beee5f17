"""chip_smoke.py on the CPU: its phase functions at tiny widths (the GPU
check is the one part left out), its device check, and its refusal to run
anywhere but on a GPU."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from leaxer_qwen3_tts_tpu.config import PRESET_SPEAKERS
from leaxer_qwen3_tts_tpu.frontend import Tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke_env(tiny_model, tmp_path_factory):
    """Tiny model with a speaker table, the smoke's vocab and reference WAV."""
    cfg, params = tiny_model
    d = str(tmp_path_factory.mktemp("smoke"))
    vocab = cs.write_tiny_vocab(d)
    wav = os.path.join(d, "reference.wav")
    cs.write_reference_wav(wav)
    params = dict(params, speaker_table=jax.random.normal(
        jax.random.PRNGKey(2), (len(PRESET_SPEAKERS), cfg.talker.hidden_size)) * 0.02)
    return SimpleNamespace(cfg=cfg, params=params, vocab=vocab, wav=wav, dir=d,
                           tok=Tokenizer(*vocab))


@pytest.mark.parametrize("quantize,kv_quant", [(None, False), ("int8", True)],
                         ids=["f32", "int8-kvq"])
def test_engine_phase_tiny(smoke_env, quantize, kv_quant):
    e = smoke_env
    out = cs.engine_phase("tiny", e.cfg, e.params, e.tok, e.wav, quantize=quantize,
                          kv_quant=kv_quant, max_tokens=12, max_frames=16, chunk_len=4,
                          first_chunk_len=2)
    assert out["synthesize"]["frames"] > 0
    assert out["stream"]["max_abs_diff_vs_offline"] == 0.0
    assert out["spec_k4"]["equals_sequential"]
    for k in ("clone", "speaker"):
        assert out[k]["finite"]


def test_spec_exact_phase_tiny(smoke_env):
    e = smoke_env
    out = cs.spec_exact_phase(e.cfg, e.params, e.tok, max_tokens=12, max_frames=16)
    assert out["equals_sequential"] and out["first_differing_frame"] is None


def test_served_model_is_the_f32_model_cast():
    """make_params + as_config_dtypes gives init_params' tree, dtypes and
    (rounded) values for the served config without a second init."""
    from conftest_util import build_tiny_cfg

    from leaxer_qwen3_tts_tpu.runtime.weights import init_params

    cfg = cs.with_dtype(build_tiny_cfg(), "bfloat16")
    p32 = cs.make_params(cs.with_dtype(cfg, "float32"), seed=0)
    got = cs.as_config_dtypes(cfg, p32)
    want = init_params(cfg, jax.random.PRNGKey(0))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
    wq = got["talker"]["transformer"]["layers"]["wq"]
    np.testing.assert_array_equal(
        np.asarray(wq, np.float32),
        np.asarray(p32["talker"]["transformer"]["layers"]["wq"].astype(jnp.bfloat16), np.float32))


def test_pool_phase_tiny(smoke_env):
    from leaxer_qwen3_tts_tpu.api.engine import TTSEngine

    e = smoke_env
    eng = TTSEngine(config=e.cfg, params=e.params, tokenizer=e.tok, max_frames=16,
                    chunk_len=4, kv_buckets=())
    out = cs.pool_phase(eng, requests=4, slots=2, max_tokens=6)
    assert out["requests"] == 4 and out["stream_chunks"] >= 1


def test_cli_phase_tiny(smoke_env, tmp_path):
    e = smoke_env
    out = cs.cli_phase(e.cfg, e.params, e.vocab, str(tmp_path), max_tokens=6)
    assert out["rc"] == 0 and out["sample_rate"] == 24000 and out["samples"] > 0


def test_train_phase_tiny(tiny_model):
    cfg, params = tiny_model
    out = cs.train_phase(cfg, params)
    assert len(out["losses"]) == 3


def _tp4_model():
    """Tiny model whose every tensor-parallel dim divides by 4."""
    from conftest_util import build_tiny_cfg

    from leaxer_qwen3_tts_tpu.runtime.weights import init_params

    cfg = build_tiny_cfg()
    r = dataclasses.replace
    tr = r(cfg.talker.transformer, num_heads=8, num_kv_heads=4, head_dim=8)
    cfg = r(cfg, talker=r(cfg.talker, transformer=tr),
            code_predictor=r(cfg.code_predictor, transformer=tr))
    return cfg, init_params(cfg, jax.random.PRNGKey(0))


def test_four_gpu_engine_phase_on_virtual_devices():
    """The TP=4 engine path and its spread checks, on 4 virtual CPU devices."""
    cfg, params = _tp4_model()
    out = cs.four_gpu_engine_phase(cfg, params, jax.devices()[:4], n_steps=4)
    assert out["wq_devices"] == 4 and out["kv_devices"] == 4
    assert out["logits_rel_l2_vs_one_gpu"] <= 1e-5  # f32 at "highest" precision


def test_four_gpu_train_phase_on_virtual_devices(tiny_model):
    cfg, params = tiny_model
    out = cs.four_gpu_train_phase(cfg, params, jax.devices()[:4])
    assert out["mesh"] == {"data": 2, "model": 2}
    assert out["max_rel_diff"] <= 1e-4


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="NVIDIA GPU"):
        cs.require_gpu(jax.devices())
    with pytest.raises(SystemExit, match="JAX found 0 none"):
        cs.require_gpu([])


def test_require_gpu_counts_devices():
    gpu = SimpleNamespace(platform="gpu")
    cs.require_gpu([gpu])  # one GPU is enough for the default run
    with pytest.raises(SystemExit, match="needs 4"):
        cs.require_gpu([gpu], count=4)
    cs.require_gpu([gpu] * 4, count=4)


@pytest.mark.gpu
def test_gpu_device_passes_check(gpu_device):
    cs.require_gpu([gpu_device])


def _run(script, cwd, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", **(extra_env or {}))
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return not lines or '"ok"' not in lines[-1]


def test_exits_nonzero_without_gpu():
    proc = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert proc.returncode != 0
    assert "NVIDIA GPU" in proc.stderr
    assert _no_result(proc)


def test_exits_nonzero_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert proc.returncode != 0
    assert _no_result(proc)


def test_result_line_shape(monkeypatch, capsys):
    """main() ends with exactly one JSON object naming the device."""
    gpu = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(jax, "devices", lambda: [gpu])
    monkeypatch.setattr(cs, "run_one_gpu", lambda workdir: None)
    monkeypatch.setattr(cs, "nvidia_smi", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(cs, "enable_compile_cache", lambda: "/cache")
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
