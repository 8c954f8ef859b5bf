"""DeepFM — Factorization-Machine + deep tower CTR model (SURVEY.md C16).

Fourth model family next to DLRM, CTR-MLP and DCNv2 (reference scope:
README.md:2 "recommendation, search, CTR and advertising"). Three heads over
shared per-feature embeddings, summed into one logit (Guo et al., 2017):

  - FM second order: 0.5 * sum_d[(sum_i e_id)^2 - sum_i e_id^2] — all
    pairwise embedding interactions in O(S*D), pure elementwise + sums
    (no [S,S] materialization, unlike DLRM's dot-interaction).
  - first order: a learned per-feature projection w_i . e_i (the classic
    per-id scalar weight folded into the shared dynamic table — one table,
    no separate 1-dim lookup).
  - deep: ReLU MLP (cfg.top_mlp) over [dense | flattened embeddings].

Every op is a batched matmul or an XLA-fusable elementwise — no dynamic
shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from meepoembedding_tpu.config import ModelConfig
from meepoembedding_tpu.models.common import mlp_apply, mlp_init


class DeepFM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.in_dim = cfg.num_dense_features + cfg.num_sparse_features * cfg.embedding_dim

    def init(self, key):
        cfg = self.cfg
        dt = jnp.dtype(cfg.dtype)
        k1, k2, k3 = jax.random.split(key, 3)
        # per-feature first-order projection [S, D] (feature i's scalar
        # weight for an id is w1[i] . e_id)
        w1 = (jax.random.normal(k1, (cfg.num_sparse_features, cfg.embedding_dim),
                                dt) * jnp.sqrt(1.0 / cfg.embedding_dim).astype(dt))
        deep = mlp_init(k2, cfg.top_mlp, self.in_dim, dt)
        wd = jax.random.normal(k3, (cfg.num_dense_features,), dt) * dt.type(0.1)
        return {"w1": w1, "deep": deep, "wd": wd, "b": jnp.zeros(())}

    def apply(self, params, dense, emb):
        """dense [B, ND]; emb [B, NS, D] -> logits [B]."""
        assert emb.shape[1] == self.cfg.num_sparse_features, (
            f"emb carries {emb.shape[1]} sparse features, model configured "
            f"for {self.cfg.num_sparse_features}"
        )
        assert dense.shape[1] == self.cfg.num_dense_features, (
            f"dense carries {dense.shape[1]} features, model configured "
            f"for {self.cfg.num_dense_features}"
        )
        b = dense.shape[0]
        s = jnp.sum(emb, axis=1)  # [B, D]
        fm2 = 0.5 * jnp.sum(s * s - jnp.sum(emb * emb, axis=1), axis=1)  # [B]
        first = jnp.sum(emb * params["w1"][None, :, :], axis=(1, 2))  # [B]
        x = jnp.concatenate(
            [dense, emb.reshape(b, -1)], axis=1, dtype=params["wd"].dtype
        )
        deep = mlp_apply(params["deep"], x).reshape(-1).astype(jnp.float32)
        lin_d = jnp.dot(dense.astype(params["wd"].dtype), params["wd"],
                        preferred_element_type=jnp.float32)
        return (fm2 + first + deep + lin_d + params["b"]).astype(jnp.float32)
