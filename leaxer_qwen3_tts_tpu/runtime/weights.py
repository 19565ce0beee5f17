"""Weight pipeline: init, save/load, and checkpoint conversion entry points.

The reference "loads weights" by creating ONNX sessions over 8 graph files
(tts_onnx.cpp:84-130); here weights are a single pytree persisted as npz or
safetensors with '/'-joined flat keys, loaded host-side then device_put with the
desired shardings by the caller.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TTSModelConfig
from ..models.codec12hz import init_vocoder_params
from ..models.code_predictor import init_code_predictor_params
from ..models.embeddings import init_embedding_params
from ..models.speaker_encoder import init_speaker_encoder_params
from ..models.talker import init_talker_params

CONFIG_FILE = "config.json"
WEIGHTS_NPZ = "params.npz"
WEIGHTS_SAFETENSORS = "params.safetensors"


def init_params(cfg: TTSModelConfig, key: jax.Array, with_speaker_encoder: bool = True) -> dict:
    """Random-init full parameter pytree (correct shapes/dtypes for every module)."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    params = {
        "talker": init_talker_params(cfg.talker, k1),
        "code_predictor": init_code_predictor_params(cfg.code_predictor, k2),
        "embeddings": init_embedding_params(cfg.talker, cfg.code_predictor, k3),
        "vocoder": init_vocoder_params(cfg.vocoder, k4),
    }
    if with_speaker_encoder and cfg.speaker_encoder is not None:
        params["speaker_encoder"] = init_speaker_encoder_params(cfg.speaker_encoder, k5)
    if cfg.draft is not None:
        from ..models.draft import init_draft_params

        params["draft"] = init_draft_params(cfg.draft, k6)
    return params


def param_count(params) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))


# ---------------------------------------------------------------------------
# Flatten / unflatten with '/'-joined keys (lists use numeric segments)
# ---------------------------------------------------------------------------


def flatten_params(params, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(flatten_params(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(params)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


# ---------------------------------------------------------------------------
# Save / load
# ---------------------------------------------------------------------------


def save_checkpoint(model_dir: str, cfg: TTSModelConfig, params, fmt: str = "npz") -> None:
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, CONFIG_FILE), "w") as f:
        f.write(cfg.to_json())
    flat = flatten_params(jax.device_get(params))
    if fmt == "npz":
        np.savez(os.path.join(model_dir, WEIGHTS_NPZ), **flat)
    elif fmt == "safetensors":
        from safetensors.numpy import save_file

        # safetensors has no bf16-numpy bridge pre-ml_dtypes-aware versions; keep raw
        save_file(flat, os.path.join(model_dir, WEIGHTS_SAFETENSORS))
    else:
        raise ValueError(f"unknown checkpoint format {fmt!r}")


def load_config(model_dir: str) -> TTSModelConfig:
    with open(os.path.join(model_dir, CONFIG_FILE)) as f:
        return TTSModelConfig.from_json(f.read())


def load_checkpoint(model_dir: str) -> Tuple[TTSModelConfig, dict]:
    """Load (config, params) from a model dir written by save_checkpoint (or by
    tools/convert_*.py)."""
    cfg = load_config(model_dir)
    npz_path = os.path.join(model_dir, WEIGHTS_NPZ)
    st_path = os.path.join(model_dir, WEIGHTS_SAFETENSORS)
    if os.path.exists(npz_path):
        with np.load(npz_path) as data:
            flat = {k: data[k] for k in data.files}
    elif os.path.exists(st_path):
        from safetensors.numpy import load_file

        flat = load_file(st_path)
    else:
        raise FileNotFoundError(f"no {WEIGHTS_NPZ} or {WEIGHTS_SAFETENSORS} in {model_dir}")
    params = unflatten_params(flat)
    return cfg, jax.tree.map(_from_saved, params)


def _from_saved(a: np.ndarray) -> jax.Array:
    # np.save writes bfloat16 (an ml_dtypes type numpy does not know) as raw
    # 2-byte void: restore the type from the bits
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        a = a.view(jnp.bfloat16)
    return jnp.asarray(a)


def model_dir_is_checkpoint(model_dir: str) -> bool:
    return os.path.exists(os.path.join(model_dir, CONFIG_FILE)) and (
        os.path.exists(os.path.join(model_dir, WEIGHTS_NPZ))
        or os.path.exists(os.path.join(model_dir, WEIGHTS_SAFETENSORS))
    )
