"""BST — Behavior Sequence Transformer (SURVEY.md C16; README.md:2 "CTR and
advertising systems").

The sequence-aware step up from DIN (models/din.py): instead of a learned
scalar weight per behavior, a transformer encoder models ORDER and
interactions *within* the user's behavior sequence, with the candidate item
as an extra token (the Alibaba BST formulation). Input convention matches
DIN: sparse feature 0 is the target item, feature 1 is the ordered behavior
sequence (its bag index IS the position), features 2.. are plain context
features pooled by masked mean.

Tokens = [target] + feature-1 bag elements, plus learned position
embeddings; `transformer_blocks` post-LN encoder blocks (multi-head
self-attention over valid tokens + ReLU FFN) run on them. The encoded
sequence is masked-mean-pooled and concatenated with the dense features,
the raw target vector, and the pooled context features into the top MLP.

Shapes: attention is three batched [B*T, D] x [D, D] projections plus a
[B, H, T, T] logits einsum; T = bag_len + 1 is static so XLA sees fixed
shapes. Padded tokens are masked out of the softmax (additive -1e9 on
KEYS) and zeroed before pooling; their gradients die at the sparse
optimizer's slot<0 mask, matching pool_bags' contract. LayerNorm and softmax
accumulate in f32 regardless of tower dtype.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from meepoembedding_tpu.config import ModelConfig
from meepoembedding_tpu.models.common import mlp_apply, mlp_init


def _layer_norm(x, scale, bias, eps=1e-6):
    xf = x.astype(jnp.float32)
    mu = xf.mean(-1, keepdims=True)
    var = jnp.square(xf - mu).mean(-1, keepdims=True)
    return ((xf - mu) * jax.lax.rsqrt(var + eps) * scale + bias).astype(x.dtype)


class BST:
    pools_inside = True

    def __init__(self, cfg: ModelConfig):
        assert cfg.num_sparse_features >= 2, (
            "BST needs a target feature (column 0) plus a behavior sequence "
            "(column 1)"
        )
        d, h = cfg.embedding_dim, cfg.attention_heads
        assert d % h == 0, f"embedding_dim {d} must divide attention_heads {h}"
        self.cfg = cfg
        self.num_context = cfg.num_sparse_features - 2

    def init(self, key):
        cfg = self.cfg
        dt = jnp.dtype(cfg.dtype)
        d = cfg.embedding_dim
        keys = jax.random.split(key, 3 + cfg.transformer_blocks)
        blocks = []
        for i in range(cfg.transformer_blocks):
            bk = jax.random.split(keys[3 + i], 6)
            s = jnp.sqrt(1.0 / d).astype(dt)
            blocks.append({
                "wq": jax.random.normal(bk[0], (d, d), dt) * s,
                "wk": jax.random.normal(bk[1], (d, d), dt) * s,
                "wv": jax.random.normal(bk[2], (d, d), dt) * s,
                "wo": jax.random.normal(bk[3], (d, d), dt) * s,
                "ffn": mlp_init(bk[4], (4 * d, d), d, dt),
                "ln1": (jnp.ones((d,), jnp.float32), jnp.zeros((d,), jnp.float32)),
                "ln2": (jnp.ones((d,), jnp.float32), jnp.zeros((d,), jnp.float32)),
            })
        top_in = cfg.num_dense_features + 2 * d + self.num_context * d
        return {
            "pos": jax.random.normal(keys[0], (cfg.max_seq_len, d), dt) * 0.02,
            "blocks": blocks,
            "top": mlp_init(keys[1], cfg.top_mlp, top_in, dt),
        }

    def _encode(self, params, tokens, tok_valid):
        """tokens [B, T, D], tok_valid [B, T] -> encoded [B, T, D]."""
        cfg = self.cfg
        b, t, d = tokens.shape
        h = cfg.attention_heads
        dh = d // h
        neg = jnp.where(tok_valid, 0.0, -1e9).astype(jnp.float32)  # key mask
        x = tokens
        for blk in params["blocks"]:
            q = jnp.dot(x, blk["wq"], preferred_element_type=jnp.float32)
            k = jnp.dot(x, blk["wk"], preferred_element_type=jnp.float32)
            v = jnp.dot(x, blk["wv"], preferred_element_type=jnp.float32)
            q = q.reshape(b, t, h, dh).transpose(0, 2, 1, 3)  # [B, H, T, dh]
            k = k.reshape(b, t, h, dh).transpose(0, 2, 1, 3)
            v = v.reshape(b, t, h, dh).transpose(0, 2, 1, 3)
            logits = jnp.einsum(
                "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
            ) / jnp.sqrt(jnp.float32(dh))
            logits = logits + neg[:, None, None, :]  # mask padded KEYS
            att = jax.nn.softmax(logits, axis=-1)
            ctxv = jnp.einsum(
                "bhqk,bhkd->bhqd", att, v, preferred_element_type=jnp.float32
            ).transpose(0, 2, 1, 3).reshape(b, t, d).astype(x.dtype)
            ctxv = jnp.dot(ctxv, blk["wo"], preferred_element_type=jnp.float32
                           ).astype(x.dtype)
            x = _layer_norm(x + ctxv, *blk["ln1"])
            y = mlp_apply(blk["ffn"], x, final_activation=False)
            x = _layer_norm(x + y, *blk["ln2"])
        return x

    def apply(self, params, dense, emb, bag_valid=None):
        """dense [B, ND]; emb [B, S, L, D] raw bag rows (or [B, S, D]
        one-hot); bag_valid [B, S, L] bool or None -> logits [B]."""
        cfg = self.cfg
        if emb.ndim == 3:  # one-hot: bags of one
            emb = emb[:, :, None, :]
        b, s, L, d = emb.shape
        if bag_valid is None:
            bag_valid = jnp.ones((b, s, L), bool)
        assert L + 1 <= cfg.max_seq_len, (
            f"bag_len {L} + target exceeds model.max_seq_len {cfg.max_seq_len}"
        )
        embf = emb.astype(jnp.float32)
        bvf = bag_valid.astype(jnp.float32)

        # target vector: masked mean of feature-0's bag (usually L = 1)
        tcnt = jnp.maximum(bvf[:, 0].sum(1, keepdims=True), 1.0)
        target = jnp.sum(embf[:, 0] * bvf[:, 0, :, None], axis=1) / tcnt  # [B, D]

        # token sequence: target + ordered behaviors (feature 1)
        tokens = jnp.concatenate([target[:, None, :], embf[:, 1]], axis=1)
        tok_valid = jnp.concatenate(
            [jnp.any(bag_valid[:, 0], 1, keepdims=True), bag_valid[:, 1]], axis=1
        )  # [B, T]
        t = L + 1
        tokens = (tokens + params["pos"][:t].astype(jnp.float32)).astype(
            jnp.dtype(cfg.dtype)
        )
        enc = self._encode(params, tokens, tok_valid).astype(jnp.float32)
        tvf = tok_valid.astype(jnp.float32)
        seq = jnp.sum(enc * tvf[..., None], axis=1) / jnp.maximum(
            tvf.sum(1, keepdims=True), 1.0
        )  # [B, D] masked mean over valid tokens

        parts = [dense.astype(jnp.float32), target, seq]
        if self.num_context:
            ccnt = jnp.maximum(bvf[:, 2:].sum(2, keepdims=True), 1.0)
            ctx = jnp.sum(embf[:, 2:] * bvf[:, 2:, :, None], axis=2) / ccnt
            parts.append(ctx.reshape(b, -1))
        z = jnp.concatenate(parts, axis=1)
        return mlp_apply(params["top"], z).reshape(-1).astype(jnp.float32)
