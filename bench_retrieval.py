"""Retrieval-path benchmark: two-tower index build rate and exact top-k
query throughput/latency over an on-device item corpus (retrieval.py;
README.md:2 "recommendation, search" serving).

Prints one JSON line per phase:
  {"phase": "index_build", "items_per_sec": ..., "items": N}
  {"phase": "topk", "queries_per_sec": ..., "p50_ms": ..., "p99_ms": ...,
   "corpus": N, "k": K, "dim": E, "index_dtype": ...}

Env knobs: MEEPO_RET_ITEMS (default 1M), MEEPO_RET_DIM (64; the item-vector
dim = bottom_mlp[-1]), MEEPO_RET_BATCH (256 queries/request), MEEPO_RET_K
(100), MEEPO_RET_STEPS (30), MEEPO_RET_DTYPE (float32|bfloat16 index).
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from meepoembedding_tpu.device import bench_device

    bench_device()
    items = int(os.environ.get("MEEPO_RET_ITEMS", 1 << 20))
    dim = int(os.environ.get("MEEPO_RET_DIM", 64))
    batch = int(os.environ.get("MEEPO_RET_BATCH", 256))
    k = int(os.environ.get("MEEPO_RET_K", 100))
    steps = int(os.environ.get("MEEPO_RET_STEPS", 30))
    idx_dtype = os.environ.get("MEEPO_RET_DTYPE", "float32")

    from meepoembedding_tpu.config import ModelConfig
    from meepoembedding_tpu.models import build_model
    from meepoembedding_tpu.retrieval import ItemIndex

    import jax

    # towers only — the table lookup path is covered by bench.py; this
    # harness isolates the retrieval-specific costs (tower + MIPS top-k)
    emb_dim = 32
    mc = ModelConfig(
        kind="two_tower", num_dense_features=8, num_sparse_features=4,
        num_query_features=2, embedding_dim=emb_dim,
        bottom_mlp=(256, 128, dim), top_mlp=(8, 1),
    )
    model = build_model(mc)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    # --- index build: item tower over the corpus -----------------------------
    embed_item = jax.jit(lambda rows: model.embed_item(params, rows))
    bb = 1 << 14
    n_pad = -(-items // bb) * bb
    log(f"embedding {items} items (batch {bb})...")
    chunks = []
    t0 = None
    for s in range(0, n_pad, bb):
        rows = rng.normal(size=(bb, mc.num_sparse_features - mc.num_query_features,
                                emb_dim)).astype(np.float32) * 0.05
        out = embed_item(rows)
        if s == 0:  # exclude compile from the rate
            out.block_until_ready()
            t0 = time.perf_counter()
        chunks.append(np.asarray(out))
    dt = time.perf_counter() - t0
    built = max(n_pad - bb, 1)
    print(json.dumps({
        "phase": "index_build",
        "items_per_sec": round(built / dt, 1),
        "items": items,
    }), flush=True)
    vecs = np.concatenate(chunks)[:items]

    # --- top-k queries --------------------------------------------------------
    index = ItemIndex(vecs, dtype=idx_dtype)
    embed_query = jax.jit(lambda d, rows: model.embed_query(params, d, rows))
    lat = []
    for i in range(steps + 1):
        dense = rng.normal(size=(batch, mc.num_dense_features)).astype(np.float32)
        qrows = rng.normal(
            size=(batch, mc.num_query_features, emb_dim)
        ).astype(np.float32) * 0.05
        t0 = time.perf_counter()
        qv = embed_query(dense, qrows)
        keys, scores = index.topk(np.asarray(qv), k)
        assert keys.shape == (batch, min(k, items))
        if i:  # first iteration pays the compile
            lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat)
    print(json.dumps({
        "phase": "topk",
        "queries_per_sec": round(batch * len(lat) / (lat.sum() / 1e3), 1),
        "p50_ms": round(float(np.percentile(lat, 50)), 3),
        "p99_ms": round(float(np.percentile(lat, 99)), 3),
        "corpus": items,
        "k": k,
        "dim": dim,
        "index_dtype": idx_dtype,
    }), flush=True)


if __name__ == "__main__":
    main()
