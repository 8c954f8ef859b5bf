"""DLRM (Deep Learning Recommendation Model) dense tower (SURVEY.md C16).

The sparse side (embedding lookups) is supplied by the dynamic table; this
module is the dense computation: bottom MLP over dense features, pairwise
dot-product feature interaction, top MLP to a CTR logit. The interaction
is one batched [B, F, D] x [B, D, F] matmul, and the upper
triangle is extracted with a static mask (no dynamic shapes under jit).

Reference-class behavior (DLRM/CTR per README.md:2 "recommendation, search,
CTR and advertising"); architecture follows the public DLRM formulation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from meepoembedding_tpu.config import ModelConfig
from meepoembedding_tpu.models.common import mlp_apply, mlp_init


class DLRM:
    def __init__(self, cfg: ModelConfig):
        assert cfg.bottom_mlp[-1] == cfg.embedding_dim, (
            "bottom MLP must end at embedding_dim for dot interaction"
        )
        self.cfg = cfg
        f = cfg.num_sparse_features + 1  # + bottom-MLP output as a feature
        iu, ju = np.triu_indices(f, k=1)
        self._triu = (jnp.asarray(iu), jnp.asarray(ju))
        self._interact_dim = len(iu)

    def init(self, key):
        cfg = self.cfg
        k1, k2 = jax.random.split(key)
        top_in = cfg.embedding_dim + self._interact_dim
        dt = jnp.dtype(cfg.dtype)
        return {
            "bottom": mlp_init(k1, cfg.bottom_mlp, cfg.num_dense_features, dt),
            "top": mlp_init(k2, cfg.top_mlp, top_in, dt),
        }

    def apply(self, params, dense, emb):
        """dense [B, ND] f32; emb [B, NS, D] -> logits [B]."""
        assert emb.shape[1] == self.cfg.num_sparse_features, (
            f"emb carries {emb.shape[1]} sparse features, model configured "
            f"for {self.cfg.num_sparse_features}"
        )
        assert dense.shape[1] == self.cfg.num_dense_features, (
            f"dense carries {dense.shape[1]} features, model configured "
            f"for {self.cfg.num_dense_features}"
        )
        x = mlp_apply(params["bottom"], dense, final_activation=True)  # [B, D]
        feats = jnp.concatenate(
            [x[:, None, :], emb.astype(x.dtype)], axis=1
        )  # [B, F, D]
        inter = jnp.einsum(
            "bfd,bgd->bfg", feats, feats, preferred_element_type=jnp.float32
        )
        iu, ju = self._triu
        flat = inter[:, iu, ju]  # [B, F*(F-1)/2]
        z = jnp.concatenate([x, flat.astype(x.dtype)], axis=1)
        return mlp_apply(params["top"], z).reshape(-1).astype(jnp.float32)
