"""Serving-path benchmark: scoring throughput/latency of ScoringService
(f32 dynamic table vs int8 quantized table) from a synthetic checkpoint.

Prints one JSON line per mode:
  {"mode": "f32"|"int8", "scores_per_sec": ..., "p50_ms": ..., "p99_ms": ...,
   "table_mb": ...}

Env knobs: MEEPO_SRV_ROWS (default 1M), MEEPO_SRV_BATCH (512),
MEEPO_SRV_STEPS (50), MEEPO_SRV_DIM (32).
"""

import json
import os
import sys
import tempfile
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from meepoembedding_tpu.device import bench_device

    bench_device()
    rows = int(os.environ.get("MEEPO_SRV_ROWS", 1 << 20))
    batch = int(os.environ.get("MEEPO_SRV_BATCH", 512))
    steps = int(os.environ.get("MEEPO_SRV_STEPS", 50))
    dim = int(os.environ.get("MEEPO_SRV_DIM", 32))

    from meepoembedding_tpu.config import ModelConfig, TableConfig
    from meepoembedding_tpu.serving import ScoringService
    from meepoembedding_tpu.table.runtime import DynamicEmbeddingTable

    nd, ns = 4, 8
    table_cfg = TableConfig(dim=dim, capacity=1 << max(10, rows.bit_length()))
    model_cfg = ModelConfig(
        kind="ctr_mlp", num_dense_features=nd, num_sparse_features=ns,
        embedding_dim=dim, top_mlp=(64, 1),
    )

    # build a checkpoint with `rows` live rows
    log(f"building {rows}-row checkpoint (dim {dim})...")
    t = DynamicEmbeddingTable(table_cfg)
    ids_all = (np.arange(1, rows + 1, dtype=np.int64)
               * np.int64(0x9E3779B97F4A7C15 & 0x7FFFFFFFFFFFFFFF))
    for o in range(0, rows, 1 << 18):
        t.lookup(ids_all[o:o + (1 << 18)])
    ck = tempfile.mkdtemp(prefix="meepo_srv_bench_")
    t.save(ck)
    del t

    rng = np.random.default_rng(0)

    def batches():
        for _ in range(steps):
            yield (
                rng.normal(size=(batch, nd)).astype(np.float32),
                ids_all[rng.integers(0, rows, size=(batch, ns))],
            )

    def run_one(mode, svc, mb):
        d0, i0 = next(iter(batches()))
        svc.score(d0, i0)  # compile
        lat = []
        t0 = time.perf_counter()
        for dense, ids in batches():
            s0 = time.perf_counter()
            svc.score(dense, ids)
            lat.append((time.perf_counter() - s0) * 1e3)
        dt = time.perf_counter() - t0
        print(json.dumps({
            "mode": mode,
            "scores_per_sec": round(steps * batch / dt, 1),
            "p50_ms": round(float(np.percentile(lat, 50)), 2),
            "p99_ms": round(float(np.percentile(lat, 99)), 2),
            "table_mb": round(mb, 1),
        }), flush=True)

    for mode, q in (("f32", "none"), ("int8", "int8")):
        svc = ScoringService(ck, table_cfg, model_cfg, quantize=q)
        mb = (svc.table.nbytes() if q == "int8"
              else svc.table.spec.hbm_bytes()) / 1e6
        run_one(mode, svc, mb)

    # distributed service over every local device (S=1 on the single-chip
    # bench rig: prices the service stack + probe-only exchange wrapper;
    # multi-chip QPS scales with the mesh by construction)
    from meepoembedding_tpu.parallel.mesh import make_mesh
    from meepoembedding_tpu.serving_sharded import ShardedScoringService

    svc = ShardedScoringService(ck, table_cfg, model_cfg, mesh=make_mesh())
    run_one(f"sharded_S{svc.S}", svc,
            svc.spec.hbm_bytes() * svc.S / 1e6)


if __name__ == "__main__":
    main()
