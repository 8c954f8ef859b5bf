"""Shared pure-JAX model pieces (SURVEY.md C16). No framework dependency:
params are plain pytrees so they shard/donate cleanly under jit."""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp


def mlp_init(key, sizes: Sequence[int], in_dim: int, dtype=jnp.float32):
    """He-init MLP params: list of (W, b)."""
    params = []
    d = in_dim
    for i, h in enumerate(sizes):
        key, k1 = jax.random.split(key)
        w = jax.random.normal(k1, (d, h), dtype) * jnp.sqrt(2.0 / d).astype(dtype)
        params.append((w, jnp.zeros((h,), dtype)))
        d = h
    return params


def mlp_apply(params, x, final_activation: bool = False):
    """ReLU MLP; the last layer is linear unless final_activation. Matmuls
    stay batched and 2-D. Activations are kept in the params' dtype (bf16
    params -> bf16 activations with f32 accumulation, the usual
    mixed-precision recipe)."""
    n = len(params)
    for i, (w, b) in enumerate(params):
        x = (jnp.dot(x.astype(w.dtype), w,
                     preferred_element_type=jnp.float32) + b).astype(w.dtype)
        if i < n - 1 or final_activation:
            x = jax.nn.relu(x)
    return x


def bce_with_logits(logits, labels):
    """Binary cross-entropy on logits, numerically stable."""
    z = logits.reshape(-1)
    y = labels.reshape(-1).astype(jnp.float32)
    return jnp.mean(jnp.maximum(z, 0) - z * y + jnp.log1p(jnp.exp(-jnp.abs(z))))


def model_inputs(model, emb_flat, hi, bag_valid, dim: int, combiner: str):
    """[n, dim] gathered rows (batch order) -> the model's embedding input.
    Attention-pooling models (`pools_inside = True`, e.g. models/din.py)
    receive the raw [B, S, L, dim] bag rows and pool with their own learned
    weights; everything else gets the param-free combiner-pooled [B, S, dim]
    (ops/pooling.py). One-hot [B, S] batches reshape either way."""
    from meepoembedding_tpu.ops import pooling

    if getattr(model, "pools_inside", False) and hi.ndim == 3:
        return emb_flat.reshape(hi.shape + (dim,))
    return pooling.pool_or_reshape(emb_flat, hi, bag_valid, dim, combiner)


def model_apply(model, params, dense, emb, bag_valid=None):
    """Forward dispatch: pools-inside models take the bag validity mask."""
    if getattr(model, "pools_inside", False):
        return model.apply(params, dense, emb, bag_valid)
    return model.apply(params, dense, emb)


def model_loss(model, params, dense, emb, bag_valid, label, item_key=None,
               logq=None):
    """Trainer-side objective dispatch, shared by the single-device and
    sharded trainers: retrieval models define `loss_and_logits` (in-batch
    softmax, models/two_tower.py); CTR rankers use pointwise BCE over
    `apply()` logits. Returns (loss, per-example metric logits)."""
    fn = getattr(model, "loss_and_logits", None)
    if fn is not None:
        return fn(params, dense, emb, label, item_key, logq=logq)
    logits = model_apply(model, params, dense, emb, bag_valid)
    return bce_with_logits(logits, label), logits


def batch_item_key(model, hi, lo):
    """[B] item identity key for accidental-hit masking, or None for models
    without one (pure function of the id planes; safe to trace)."""
    fn = getattr(model, "item_key", None)
    return None if fn is None else fn(hi, lo)
