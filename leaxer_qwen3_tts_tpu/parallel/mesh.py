"""Device mesh + sharding rules (JAX SPMD in place of a multi-GPU runtime).

The reference has no distributed anything (SURVEY §2.3: single process, single
``Ort::Env``, batch fixed at 1).  Here scale-out is native JAX SPMD:

  * mesh axes ``("data", "model")`` — data parallelism shards the request
    batch (multi-stream serving); tensor parallelism shards
    attention heads / MLP / vocab for the 1.7B-class variants.
  * collectives are XLA's (psum/all_gather inserted by GSPMD from the
    shardings below); on GPUs XLA hands them to NCCL.
  * pipeline/expert parallelism are explicit non-goals at this model scale
    (0.6-1.7B, 28 layers; SURVEY §2.3).

``shard_params`` places a parameter pytree according to TP rules keyed on
pytree paths; unlisted leaves replicate.  GSPMD then propagates activation
shardings from the placed params (q/k/v sharded on heads -> KV cache sharded
on heads; batch sharded on data from the token inputs).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    data: int = 1,
    model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ("data", "model") mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = data * model
    if n > len(devices):
        raise ValueError(f"mesh {data}x{model} needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def auto_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """Mesh using all devices: `model_parallel`-way TP, rest data-parallel."""
    n = n_devices if n_devices is not None else len(jax.devices())
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return make_mesh(data=n // model_parallel, model=model_parallel)


# ---------------------------------------------------------------------------
# Tensor-parallel sharding rules, keyed on '/'-joined pytree paths.
# Layer stacks carry a leading [num_layers] axis (models/layers.py), hence the
# leading None in every transformer rule.
# ---------------------------------------------------------------------------

# (path regex, PartitionSpec) — first match wins.
TP_RULES: Tuple[Tuple[str, P], ...] = (
    # attention: q/k/v project onto heads (shard out dim), o projects back
    (r".*/layers/wq$", P(None, None, "model")),
    (r".*/layers/wk$", P(None, None, "model")),
    (r".*/layers/wv$", P(None, None, "model")),
    (r".*/layers/wo$", P(None, "model", None)),
    # MLP: gate/up shard out dim, down shards in dim
    (r".*/layers/wg$", P(None, None, "model")),
    (r".*/layers/wu$", P(None, None, "model")),
    (r".*/layers/wd$", P(None, "model", None)),
    # output heads: shard the vocab dim
    (r".*talker/lm_head$", P(None, "model")),
    (r".*code_predictor/heads$", P(None, None, "model")),
    (r".*code_predictor/head$", P(None, "model")),  # shared-head fallback
    # text embedding: shard the embed dim; the projection consumes it sharded
    # (partial-sum matmul -> psum inserted by GSPMD)
    (r".*embeddings/text_embed$", P(None, "model")),
    (r".*embeddings/text_proj$", P("model", None)),
    # everything else (codec/pred embeds, norms, vocoder, speaker enc): replicate
)


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def param_pspec(path: str) -> P:
    for pattern, spec in TP_RULES:
        if re.match(pattern, path):
            return spec
    return P()  # replicate


def param_shardings(mesh: Mesh, params) -> object:
    """Pytree of NamedSharding matching `params` (TP rules; replicate default)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_pspec(_path_str(path))),
        params,
    )


def shard_params(mesh: Mesh, params):
    """device_put the parameter pytree onto the mesh per the TP rules."""
    return jax.device_put(params, param_shardings(mesh, params))


def data_sharding(mesh: Mesh, *batch_axes_first: int) -> NamedSharding:
    """Sharding for a batch-leading array: batch on "data", rest replicated."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
