"""Pooled multi-hot embedding lookup (SURVEY.md C16/C17).

The reference class serves TF-style recommenders whose sparse features are
variable-length id BAGS pooled per example (`embedding_lookup_sparse` with a
sum/mean/sqrtn combiner — README.md:2 "lookuptable-style ... Embedding").

Layout: a bag is a fixed `[B, S, L]` id tensor padded with the
reserved invalid sentinel (`hashing.EMPTY_ID`) instead of ragged
values+offsets — static shapes keep the whole step jittable, and padding ids
ride the EXISTING invalid-id path end to end: dedup groups them into one
invalid unique, lookups return zero rows for it, and its gradients are
dropped by the slot<0 mask in the sparse optimizer. Pooling itself is then
pure elementwise arithmetic over the gathered rows; no new table machinery.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

COMBINERS = ("sum", "mean", "sqrtn")


def bag_counts(bag_valid: jax.Array) -> jax.Array:
    """[B, S, L] validity -> [B, S] f32 count of real ids per bag."""
    return jnp.sum(bag_valid.astype(jnp.float32), axis=-1)


def pool_bags(emb: jax.Array, bag_valid: jax.Array, combiner: str) -> jax.Array:
    """[B, S, L, dim] rows + [B, S, L] validity -> [B, S, dim] pooled rows.

    Rows under invalid (padding) lanes MUST already be zero — the lookup path
    guarantees this (invalid ids resolve to slot -1 and gather zeros) — so the
    sum needs no mask; `bag_valid` only supplies the combiner denominator.
    Empty bags pool to zeros under every combiner (count clamps to 1).

    Differentiable: the VJP broadcasts the pooled grad back over the bag with
    the combiner's weight, and padded lanes' grads die at the sparse
    optimizer's slot<0 mask, so no masking is needed on the backward either.
    """
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got {combiner!r}")
    s = jnp.sum(emb, axis=2)
    if combiner == "sum":
        return s
    cnt = jnp.maximum(bag_counts(bag_valid), 1.0)
    if combiner == "mean":
        return s / cnt[..., None]
    return s / jnp.sqrt(cnt)[..., None]  # sqrtn


def pool_or_reshape(emb_flat: jax.Array, hi: jax.Array, bag_valid, dim: int,
                    combiner: str) -> jax.Array:
    """Model-boundary adapter shared by the trainers: `[n, dim]` gathered rows
    (batch order) -> `[B, S, dim]` model inputs for both one-hot `[B, S]` and
    multi-hot `[B, S, L]` id batches."""
    emb = emb_flat.reshape(hi.shape + (dim,))
    if hi.ndim == 2:
        return emb
    return pool_bags(emb, bag_valid, combiner)
