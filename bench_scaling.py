"""Scaling-efficiency harness (SURVEY.md M4; BASELINE target: >=85%
examples/s at 2+ hosts).

Weak scaling: fixed PER-DEVICE batch; efficiency(N) =
examples_per_sec(N) / (N * examples_per_sec(1)). Runs over the visible
GPUs (four local cards for N up to 4).

Env: MEEPO_SCALE_DEVICES (mesh sizes, default "1,2,4,8" clipped to
available), MEEPO_SCALE_BATCH (per-device, default 1024),
MEEPO_SCALE_STEPS (default 10).
"""

import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from meepoembedding_tpu.device import bench_device

    bench_device()
    import jax
    import numpy as np

    from meepoembedding_tpu.config import ModelConfig, OptimizerConfig, RunConfig, TableConfig
    from meepoembedding_tpu.data.synthetic import SyntheticConfig, SyntheticStream
    from meepoembedding_tpu.parallel.mesh import make_mesh
    from meepoembedding_tpu.parallel.trainer import ShardedTrainer

    ndev = jax.device_count()
    sizes = [
        int(s) for s in os.environ.get("MEEPO_SCALE_DEVICES", "1,2,4,8").split(",")
        if int(s) <= ndev
    ]
    per_dev_batch = int(os.environ.get("MEEPO_SCALE_BATCH", 1024))
    steps = int(os.environ.get("MEEPO_SCALE_STEPS", 10))
    dim = 16

    rates = {}
    for S in sizes:
        batch = per_dev_batch * S
        run = RunConfig(batch_size=batch, steps=steps, dense_learning_rate=1e-3)
        table = TableConfig(
            dim=dim, capacity=1 << 20,
            optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
        )
        model = ModelConfig(
            kind="dlrm", num_dense_features=13, num_sparse_features=26,
            embedding_dim=dim, bottom_mlp=(64, dim), top_mlp=(64, 1),
        )
        data = SyntheticConfig(
            num_dense=13, num_sparse=26, batch_size=batch, vocab_per_feature=50000
        )
        tr = ShardedTrainer(run, table, model, mesh=make_mesh(S))
        stream = SyntheticStream(data).batches(steps + 2)
        tr.train_step(next(stream))  # compile
        tr.train_step(next(stream))
        t0 = time.perf_counter()
        for b in stream:
            # pipelined: the trainer fetches step i-depth's loss internally
            # (a real completion barrier that hides behind in-flight steps)
            tr.train_step(b)
        tr.flush()  # drain the final in-flight steps before closing the clock
        dt = time.perf_counter() - t0
        rates[S] = batch * steps / dt
        log(f"S={S}: {rates[S]:.0f} examples/s ({dt/steps*1e3:.1f} ms/step)")

    base = rates.get(1)
    out = {
        "metric": "weak_scaling_examples_per_sec",
        "platform": jax.devices()[0].platform,
        "per_device_batch": per_dev_batch,
        "rates": {str(k): round(v, 1) for k, v in rates.items()},
        "efficiency": {
            str(k): round(v / (k * base), 4) for k, v in rates.items()
        } if base else {},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
