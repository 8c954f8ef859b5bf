"""Candidate retrieval serving (README.md:2 "recommendation, search" — the
retrieval half; pairs with models/two_tower.py).

`ItemIndex` is a brute-force maximum-inner-product index kept on device:
top-k over N items is a [Q, E] x [E, N] matmul followed by `lax.top_k`,
chunked over the item axis with a running top-k merge so the score matrix
never materializes beyond [Q, chunk]. On one card this is exact (no ANN
approximation); a 10M-item x 64-dim index against a query batch of 256 is
~330 GFLOP, so index size in device memory, not compute, is the practical
bound.

`RetrievalService` wraps a restored checkpoint (via `ScoringService`, so
int8-quantized tables work too): item-side embeddings are precomputed
through the item tower into an `ItemIndex`; queries run through the query
tower and the index. This is the standard two-tower serving split — the
item corpus is embedded offline, only the query tower runs per request.
"""

from __future__ import annotations

from functools import partial

import numpy as np


def _topk_fn(k: int, nc: int):
    """Build the jitted chunked top-k: queries [Q, E], chunks [nc, C, E],
    bias [nc, C] (-inf on padding) -> (scores [Q, k], flat item idx [Q, k])."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def topk(queries, chunks, bias):
        q = queries.astype(jnp.float32)
        C = chunks.shape[1]

        def body(carry, xs):
            best_s, best_i = carry
            vecs, b, ci = xs
            s = jnp.dot(q, vecs.T.astype(jnp.float32),
                        preferred_element_type=jnp.float32) + b[None, :]
            idx = (ci * C + lax.iota(jnp.int32, C))[None, :] * jnp.ones(
                (q.shape[0], 1), jnp.int32
            )
            cs = jnp.concatenate([best_s, s], axis=1)
            cidx = jnp.concatenate([best_i, idx], axis=1)
            s2, sel = lax.top_k(cs, k)
            return (s2, jnp.take_along_axis(cidx, sel, axis=1)), None

        init = (
            jnp.full((q.shape[0], k), -jnp.inf, jnp.float32),
            jnp.full((q.shape[0], k), -1, jnp.int32),
        )
        (s, i), _ = lax.scan(
            body, init, (chunks, bias, lax.iota(jnp.int32, nc))
        )
        return s, i

    return topk


class ItemIndex:
    """Exact on-device MIPS index over item vectors.

    vectors: [N, E] float array (host or device). keys: [N] int64 external
    item identifiers returned by queries (defaults to 0..N-1).
    """

    def __init__(self, vectors, keys=None, chunk: int = 1 << 15,
                 dtype: str = "float32"):
        import jax.numpy as jnp

        v = np.asarray(vectors, np.float32)
        assert v.ndim == 2, f"vectors must be [N, E], got {v.shape}"
        self.num_items, self.dim = v.shape
        self.keys = (
            np.arange(self.num_items, dtype=np.int64)
            if keys is None
            else np.asarray(keys, np.int64)
        )
        assert len(self.keys) == self.num_items
        c = min(chunk, 1 << max(3, (self.num_items - 1).bit_length()))
        nc = -(-self.num_items // c)
        pad = nc * c - self.num_items
        if pad:
            v = np.concatenate([v, np.zeros((pad, self.dim), np.float32)])
        bias = np.zeros(nc * c, np.float32)
        bias[self.num_items:] = -np.inf
        self._chunks = jnp.asarray(
            v.reshape(nc, c, self.dim), jnp.dtype(dtype)
        )
        self._bias = jnp.asarray(bias.reshape(nc, c))
        self._fns = {}
        self._nc = nc

    def topk(self, queries, k: int):
        """[Q, E] query vectors -> (keys [Q, k] int64, scores [Q, k] f32).
        k is clamped to the corpus size; jitted per (k) value."""
        k = min(k, self.num_items)
        fn = self._fns.get(k)
        if fn is None:
            fn = self._fns[k] = _topk_fn(k, self._nc)
        s, i = fn(np.asarray(queries, np.float32), self._chunks, self._bias)
        return self.keys[np.asarray(i)], np.asarray(s)


class RetrievalService:
    """Two-tower retrieval endpoint over a restored checkpoint.

    Composes a `ScoringService` (checkpoint restore, probe-only table,
    optional int8 quantization) whose model must be a TwoTower; builds the
    item index through the item tower and serves top-k through the query
    tower.
    """

    def __init__(self, scoring, index_dtype: str = "float32",
                 embed_batch: int = 8192):
        assert hasattr(scoring.model, "embed_item"), (
            f"retrieval needs a two_tower checkpoint; model is "
            f"{type(scoring.model).__name__}"
        )
        self.scoring = scoring
        self.model = scoring.model
        self.index_dtype = index_dtype
        self.embed_batch = embed_batch
        self.index: ItemIndex | None = None
        self._jitted = {}

    def _embed_fn(self, which: str):
        import jax

        fn = self._jitted.get(which)
        if fn is not None:
            return fn
        model, params = self.model, self.scoring.params
        if which == "item":
            fn = jax.jit(lambda rows: model.embed_item(params, rows))
        else:
            fn = jax.jit(lambda dense, rows: model.embed_query(params, dense, rows))
        self._jitted[which] = fn
        return fn

    def build_index(self, item_ids: np.ndarray, keys=None) -> ItemIndex:
        """item_ids: [N, IF] int64 — each row is one candidate item's
        item-side feature ids (IF = num_sparse_features - num_query_features).
        keys: [N] external identifiers (default: row index)."""
        item_ids = np.asarray(item_ids, np.int64)
        n, itf = item_ids.shape
        assert itf == self.model.itf, (
            f"items carry {itf} features, model expects {self.model.itf}"
        )
        fn = self._embed_fn("item")
        dim = self.scoring.table_cfg.dim
        out = []
        b = self.embed_batch
        for s in range(0, n, b):
            ids = item_ids[s : s + b]
            nb = len(ids)
            rows = self.scoring.table.lookup(ids.reshape(-1), train=False)
            out.append(np.asarray(fn(np.asarray(rows).reshape(nb, itf, dim))))
        self.index = ItemIndex(
            np.concatenate(out), keys=keys, dtype=self.index_dtype
        )
        # item-feature tuple -> external key, for recall@k evaluation
        self._row_key = {
            tuple(r): k
            for r, k in zip(item_ids.tolist(), self.index.keys.tolist())
        }
        return self.index

    def evaluate(self, batches, ks=(1, 10, 100)) -> dict:
        """Recall@k over labeled (query, item) batches (the retrieval
        counterpart of AUC eval): for every positive example, does the top-k
        over the corpus contain its item? Items absent from the corpus count
        as misses. Expects one-hot [B, S] id batches."""
        assert self.index is not None, "call build_index() first"
        ks = sorted(int(k) for k in ks)
        qf = self.model.qf
        hits = {k: 0 for k in ks}
        total = 0
        for batch in batches:
            ids = np.asarray(batch["ids"], np.int64)
            assert ids.ndim == 2, (
                f"retrieval eval expects one-hot [B, S] ids, got {ids.shape}"
            )
            pos = np.asarray(batch["label"]).reshape(-1) > 0
            if not pos.any():
                continue
            truth = np.array(
                [self._row_key.get(tuple(r), -(1 << 62))
                 for r in ids[pos, qf:].tolist()],
                dtype=np.int64,
            )
            got, _ = self.retrieve(
                np.asarray(batch["dense"], np.float32)[pos], ids[pos, :qf],
                k=ks[-1],
            )
            for k in ks:
                hits[k] += int((got[:, :k] == truth[:, None]).any(1).sum())
            total += int(pos.sum())
        return {
            **{f"recall@{k}": (hits[k] / total if total else None) for k in ks},
            "positives": total,
            "corpus": self.index.num_items,
        }

    def retrieve(self, dense: np.ndarray, query_ids: np.ndarray, k: int = 10):
        """dense [Q, ND] + query-side ids [Q, QF] -> (keys [Q, k], scores)."""
        assert self.index is not None, "call build_index() first"
        dense = np.asarray(dense, np.float32)
        query_ids = np.asarray(query_ids, np.int64)
        q, qf = query_ids.shape
        assert qf == self.model.qf, (
            f"queries carry {qf} features, model expects {self.model.qf}"
        )
        dim = self.scoring.table_cfg.dim
        rows = self.scoring.table.lookup(query_ids.reshape(-1), train=False)
        vecs = self._embed_fn("query")(dense, np.asarray(rows).reshape(q, qf, dim))
        return self.index.topk(np.asarray(vecs), k)
