"""DCNv2 — Deep & Cross Network (SURVEY.md C16).

Third CTR family next to DLRM and CTR-MLP (reference scope: README.md:2
"recommendation, search, CTR and advertising"). Explicit feature crosses:

    x_{l+1} = x_0 * (W_l x_l + b_l) + x_l        (full-rank DCNv2 cross)

run in parallel with a deep ReLU tower over the same input; their concat
feeds a final linear logit. Every cross layer is one [B, I] x [I, I]
matmul plus elementwise ops XLA fuses; no dynamic shapes.
Architecture follows the public DCNv2 formulation (Wang et al., 2021).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from meepoembedding_tpu.config import ModelConfig
from meepoembedding_tpu.models.common import mlp_apply, mlp_init


class DCNv2:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.in_dim = cfg.num_dense_features + cfg.num_sparse_features * cfg.embedding_dim

    def init(self, key):
        cfg = self.cfg
        keys = jax.random.split(key, cfg.num_cross_layers + 2)
        dt = jnp.dtype(cfg.dtype)
        cross = []
        for i in range(cfg.num_cross_layers):
            w = jax.random.normal(keys[i], (self.in_dim, self.in_dim), dt)
            cross.append((w * jnp.sqrt(1.0 / self.in_dim).astype(dt),
                          jnp.zeros((self.in_dim,), dt)))
        deep = mlp_init(keys[-2], self.cfg.top_mlp[:-1] or (64,), self.in_dim, dt)
        deep_out = (self.cfg.top_mlp[:-1] or (64,))[-1]
        head = mlp_init(keys[-1], (1,), self.in_dim + deep_out, dt)
        return {"cross": cross, "deep": deep, "head": head}

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
        x0 = jnp.concatenate(
            [dense, emb.reshape(b, -1)], axis=1, dtype=self.cfg.dtype
        )  # [B, I]
        x = x0
        for w, bias in params["cross"]:
            x = x0 * (jnp.dot(x, w, preferred_element_type=jnp.float32) + bias
                      ).astype(x0.dtype) + x
        deep = mlp_apply(params["deep"], x0, final_activation=True)
        z = jnp.concatenate([x, deep], axis=1)
        return mlp_apply(params["head"], z).reshape(-1).astype(jnp.float32)
