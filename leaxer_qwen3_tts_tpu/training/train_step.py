"""Sharded training step: optax AdamW over the TTS loss, SPMD over a mesh.

Layout (see parallel/mesh.py): params tensor-parallel over "model", batch
data-parallel over "data"; GSPMD inserts the gradient psum over "data" and the
TP collectives over "model" from the shardings alone — no hand-written
collectives (XLA lowers them to NCCL on GPUs).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import TTSModelConfig
from ..parallel.mesh import param_shardings, shard_params
from .loss import LossMetrics, tts_loss


class TrainState(NamedTuple):
    params: dict
    opt_state: object
    step: jax.Array


def make_optimizer(
    learning_rate: float = 1e-4,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> optax.GradientTransformation:
    return optax.chain(
        optax.clip_by_global_norm(grad_clip),
        optax.adamw(learning_rate, b1=b1, b2=b2, weight_decay=weight_decay),
    )


def init_train_state(params: dict, tx: optax.GradientTransformation) -> TrainState:
    return TrainState(
        params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32)
    )


def make_train_step(
    cfg: TTSModelConfig,
    tx: optax.GradientTransformation,
    lang_id: Optional[int] = None,
    mtp_weight: float = 1.0,
    donate: bool = True,
):
    """Returns jitted train_step(state, batch) -> (state, LossMetrics).

    batch: dict(text_ids [B,T] i32, text_len [B] i32, codes [B,F,16] i32,
    num_frames [B] i32).  Call under a Mesh context (or single device) with
    params placed via parallel.mesh.shard_params and the batch data-sharded.
    """

    def loss_fn(params, batch):
        m = tts_loss(
            cfg,
            params,
            batch["text_ids"],
            batch["text_len"],
            batch["codes"],
            batch["num_frames"],
            lang_id=lang_id,
            mtp_weight=mtp_weight,
        )
        return m.loss, m

    def step(state: TrainState, batch) -> Tuple[TrainState, LossMetrics]:
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, batch
        )
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), metrics

    return jax.jit(step, donate_argnums=(0,) if donate else ())


def shard_train_state(mesh: Mesh, state: TrainState, tx) -> TrainState:
    """Place params on the mesh; optimizer moments are re-initialized from the
    sharded params so they inherit the same shardings (zeros_like preserves
    sharding).  Only valid at moment-free points (step 0 / after a checkpoint
    load, which re-places state anyway)."""
    params = shard_params(mesh, state.params)
    return TrainState(params=params, opt_state=tx.init(params), step=state.step)


def batch_sharding(mesh: Mesh) -> dict:
    """Shardings for the train batch dict (batch axis over "data")."""
    s = NamedSharding(mesh, P("data"))
    return {"text_ids": s, "text_len": s, "codes": s, "num_frames": s}
