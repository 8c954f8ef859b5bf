"""Two-tower retrieval model (SURVEY.md C16; README.md:2 "recommendation,
search ... systems" — the candidate-retrieval half of that workload family).

CTR models (DLRM/DCN/DeepFM) *rank* a given (user, item) pair; retrieval
*finds* the items: a query tower embeds (dense context + query-side sparse
features) and an item tower embeds item-side sparse features into a shared
space, trained with in-batch sampled softmax so that serving reduces to a
top-k maximum-inner-product search over a precomputed item index
(`meepoembedding_tpu.retrieval`).

Both towers are plain batched MLPs; the in-batch softmax logits are ONE
[B, E] x [E, B] matmul per step (no per-example negative sampling, no
gather of negatives).
Embeddings are L2-normalized with a learnable temperature (scaled cosine),
which keeps the logit scale bounded under bf16 towers.

Feature split: of the `num_sparse_features` id columns, the first
`num_query_features` belong to the query side, the rest to the item side.
The dynamic table is shared (ids are namespaced per feature by the data
pipeline), so query and item towers can even share vocabulary when ids
coincide.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from meepoembedding_tpu.config import ModelConfig
from meepoembedding_tpu.models.common import mlp_apply, mlp_init
from meepoembedding_tpu.table import hashing

# Salt decorrelating the accidental-hit item key from table/owner hashing.
_SALT_ITEM = np.uint32(0x7FEB352D)


def _l2norm(x, eps=1e-6):
    return x * jax.lax.rsqrt(jnp.sum(jnp.square(x), -1, keepdims=True) + eps)


class TwoTower:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.qf = cfg.num_query_features
        self.itf = cfg.num_sparse_features - self.qf
        assert 0 < self.qf < cfg.num_sparse_features, (
            f"two_tower needs 1 <= num_query_features < num_sparse_features; "
            f"got {self.qf} of {cfg.num_sparse_features}"
        )
        self.embed_out = cfg.bottom_mlp[-1]

    def init(self, key):
        cfg = self.cfg
        k1, k2 = jax.random.split(key)
        dt = jnp.dtype(cfg.dtype)
        d = cfg.embedding_dim
        return {
            "query": mlp_init(k1, cfg.bottom_mlp,
                              cfg.num_dense_features + self.qf * d, dt),
            "item": mlp_init(k2, cfg.bottom_mlp, self.itf * d, dt),
            # learnable inverse-temperature, kept in f32 even for bf16 towers
            "log_tau": jnp.asarray(np.log(10.0), jnp.float32),
        }

    # --- towers --------------------------------------------------------------
    def embed_query(self, params, dense, emb_q):
        """dense [B, ND] + query-side rows [B, QF, D] -> [B, E] unit vectors."""
        b = dense.shape[0]
        x = jnp.concatenate(
            [dense.astype(jnp.float32), emb_q.reshape(b, -1).astype(jnp.float32)],
            axis=1,
        )
        return _l2norm(mlp_apply(params["query"], x).astype(jnp.float32))

    def embed_item(self, params, emb_i):
        """item-side rows [B, IF, D] -> [B, E] unit vectors."""
        b = emb_i.shape[0]
        x = emb_i.reshape(b, -1).astype(jnp.float32)
        return _l2norm(mlp_apply(params["item"], x).astype(jnp.float32))

    def _split(self, emb):
        return emb[:, : self.qf, :], emb[:, self.qf :, :]

    # --- ranking-compatible apply (ScoringService / eval AUC path) -----------
    def apply(self, params, dense, emb):
        """[B] pairwise relevance logits: tau * cos(query_b, item_b). Lets the
        existing scoring/eval plumbing treat retrieval checkpoints as rankers."""
        eq, ei = self._split(emb)
        q = self.embed_query(params, dense, eq)
        v = self.embed_item(params, ei)
        tau = jnp.exp(params["log_tau"])
        return tau * jnp.sum(q * v, axis=-1)

    # --- training objective ---------------------------------------------------
    def item_key(self, hi, lo):
        """[B] int32 identity key of each example's item-side ids, for
        accidental-hit masking (two batch rows carrying the SAME item must not
        be each other's negatives). Position-salted uint32 fold; a (rare)
        uint32 collision only blanks one extra negative."""
        ehi, elo = hi[:, self.qf :], lo[:, self.qf :]  # axis 1 == features for [B,S] and [B,S,L]
        h = hashing.hash_pair(ehi, elo, _SALT_ITEM)
        # decorrelate feature positions so permuted ids hash differently
        pos = (jnp.arange(h.shape[1], dtype=jnp.uint32) + jnp.uint32(1)) if h.ndim == 2 else (
            (jnp.arange(h.shape[1], dtype=jnp.uint32) + jnp.uint32(1))[:, None]
        )
        h = hashing.fmix32(h * pos)
        if h.ndim == 3:  # multi-hot bags: fold only the valid lanes
            valid = hashing.is_valid(ehi, elo)
            h = jnp.where(valid, h, jnp.uint32(0))
            h = jax.lax.reduce(h, jnp.uint32(0), jax.lax.bitwise_xor, (1, 2))
        else:
            h = jax.lax.reduce(h, jnp.uint32(0), jax.lax.bitwise_xor, (1,))
        return h.astype(jnp.int32)

    def loss_and_logits(self, params, dense, emb, label, item_key=None,
                        logq=None):
        """In-batch sampled-softmax retrieval loss.

        Every batch row is a (query, item) pair; rows with label > 0 are
        positives whose target is their own item against the other in-batch
        items as negatives (rows with label == 0 contribute no loss but still
        serve as negatives — the CTR-stream-compatible convention). Returns
        per-example margin logits `tau*s_ii - max_j tau*s_ij` so the trainers'
        AUC/metric plumbing stays meaningful: margin > 0 == hit@1.

        logq ([B] f32, optional): log probability of each row's item
        appearing in a batch; subtracted from that item's column of logits
        before the softmax (sampling-bias-corrected softmax, Yi et al. 2019
        — ops/itemfreq.py) so popular items are not over-penalized as
        in-batch negatives. Training-only; serving scores stay raw.
        """
        eq, ei = self._split(emb)
        q = self.embed_query(params, dense, eq)  # [B, E]
        v = self.embed_item(params, ei)  # [B, E]
        tau = jnp.exp(params["log_tau"])
        scores = tau * jnp.dot(q, v.T, preferred_element_type=jnp.float32)
        b = scores.shape[0]
        eye = jnp.eye(b, dtype=bool)
        if item_key is not None:
            dup = (item_key[None, :] == item_key[:, None]) & ~eye
            scores = jnp.where(dup, -1e9, scores)
        ce_scores = scores if logq is None else scores - logq[None, :]
        logp = jax.nn.log_softmax(ce_scores, axis=1)
        w = label.reshape(-1).astype(jnp.float32)
        loss = -jnp.sum(w * jnp.diagonal(logp)) / jnp.maximum(jnp.sum(w), 1.0)
        neg = jnp.where(eye, -jnp.inf, scores)
        margin = jnp.diagonal(scores) - jnp.max(neg, axis=1)
        return loss, margin
