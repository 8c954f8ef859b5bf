"""DIN — Deep Interest Network (SURVEY.md C16; README.md:2 "CTR and
advertising systems").

The advertising-CTR pattern the param-free combiners (ops/pooling.py) can't
express: the *candidate ad* (target) decides how much each element of the
user's multi-hot behavior bags matters. Sparse feature 0 is the target; every
remaining feature is a behavior bag attended by the target — the attention
weight of bag element e against target t is an MLP over [e, t, e*t, e-t]
(the original DIN activation-unit form), masked-softmaxed over the bag.

The model declares `pools_inside = True`, so the trainers hand it the RAW
[B, S, L, D] gathered rows + validity mask instead of combiner-pooled rows
(models/common.py `model_inputs`). One-hot [B, S] batches degenerate to
L = 1 (attention over a single element is the identity), so DIN also runs —
pointlessly but correctly — on one-hot data.

Shapes: the activation unit is one batched [B, S-1, L, 4D] x [4D, H]
matmul chain; masking/softmax are elementwise ops; nothing here
introduces dynamic shapes or per-bag loops. All-padding bags pool to exact
zeros (the masked softmax is renormalized by the bag's any-valid bit), and
padded lanes' gradients die at the sparse optimizer's slot<0 mask, matching
pool_bags' contract.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from meepoembedding_tpu.config import ModelConfig
from meepoembedding_tpu.models.common import mlp_apply, mlp_init


class DIN:
    pools_inside = True

    def __init__(self, cfg: ModelConfig):
        assert cfg.num_sparse_features >= 2, (
            "DIN needs a target feature (column 0) plus >=1 behavior bag"
        )
        self.cfg = cfg
        self.num_behaviors = cfg.num_sparse_features - 1

    def init(self, key):
        cfg = self.cfg
        k1, k2 = jax.random.split(key)
        dt = jnp.dtype(cfg.dtype)
        d = cfg.embedding_dim
        top_in = (
            cfg.num_dense_features + d + self.num_behaviors * d
        )
        return {
            # activation unit: [e, t, e*t, e-t] -> scalar weight
            "att": mlp_init(k1, tuple(cfg.attention_mlp) + (1,), 4 * d, dt),
            "top": mlp_init(k2, cfg.top_mlp, top_in, dt),
        }

    def apply(self, params, dense, emb, bag_valid=None):
        """dense [B, ND]; emb [B, S, L, D] raw bag rows (or [B, S, D]
        one-hot); bag_valid [B, S, L] bool or None -> logits [B]."""
        if emb.ndim == 3:  # one-hot: a bag of one
            emb = emb[:, :, None, :]
        b, s, L, d = emb.shape
        if bag_valid is None:
            bag_valid = jnp.ones((b, s, L), bool)
        emb = emb.astype(jnp.float32)

        # target vector: masked mean of feature-0's bag (usually L=1)
        tv = bag_valid[:, 0].astype(jnp.float32)  # [B, L]
        tcnt = jnp.maximum(tv.sum(1, keepdims=True), 1.0)
        target = jnp.sum(emb[:, 0] * tv[..., None], axis=1) / tcnt  # [B, D]

        behav = emb[:, 1:]  # [B, S-1, L, D]
        bv = bag_valid[:, 1:]  # [B, S-1, L]
        t4 = jnp.broadcast_to(target[:, None, None, :], behav.shape)
        feats = jnp.concatenate(
            [behav, t4, behav * t4, behav - t4], axis=-1
        )  # [B, S-1, L, 4D]
        a = mlp_apply(params["att"], feats)[..., 0].astype(jnp.float32)
        a = jnp.where(bv, a, -1e9)
        a = jax.nn.softmax(a, axis=-1)
        # all-padding bags: softmax over all -1e9 is uniform garbage — zero it
        a = a * jnp.any(bv, axis=-1, keepdims=True).astype(jnp.float32)
        pooled = jnp.einsum(
            "bsl,bsld->bsd", a, behav, preferred_element_type=jnp.float32
        )  # [B, S-1, D]
        z = jnp.concatenate(
            [dense.astype(jnp.float32), target, pooled.reshape(b, -1)], axis=1
        )
        return mlp_apply(params["top"], z).reshape(-1).astype(jnp.float32)
