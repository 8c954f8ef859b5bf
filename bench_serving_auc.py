"""Int8 serving-quantization AUC delta (VERDICT r2 #6).

Trains the DLRM-small dynamic-table trainer on the parity stream (same
Criteo-format planted-signal TSV as bench_auc_parity), checkpoints it, then
scores the held-out slice through ScoringService twice — f32 table vs
`quantize="int8"` — and reports both AUCs. Done-gate: |delta| < 1e-3 or an
explanation in PERF.md.

Env: MEEPO_PARITY_LINES (400K), MEEPO_PARITY_BATCH (2048), MEEPO_SRV_SEED (0).
"""

import json
import os
import sys
import tempfile


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from meepoembedding_tpu.device import bench_device

    bench_device()
    import numpy as np

    from meepoembedding_tpu.config import (
        ModelConfig, OptimizerConfig, RunConfig, TableConfig,
    )
    from meepoembedding_tpu.data.criteo import (
        NUM_SPARSE, CriteoStream, write_synthetic_criteo_signal,
    )
    from meepoembedding_tpu.metrics import StreamingAUC
    from meepoembedding_tpu.serving import ScoringService
    from meepoembedding_tpu.train import Trainer

    train_lines = int(os.environ.get("MEEPO_PARITY_LINES", 400_000))
    eval_lines = 64_000
    batch = int(os.environ.get("MEEPO_PARITY_BATCH", 2048))
    seed = int(os.environ.get("MEEPO_SRV_SEED", 0))
    dim = 16

    total = train_lines + eval_lines
    tsv = os.path.join(tempfile.gettempdir(), f"meepo_parity_{total}.tsv")
    if not os.path.exists(tsv) or os.environ.get("MEEPO_PARITY_REGEN"):
        log(f"generating {total} Criteo-format lines ...")
        write_synthetic_criteo_signal(tsv, total, seed=7)

    train_steps = train_lines // batch
    eval_steps = eval_lines // batch
    model = ModelConfig(
        kind="dlrm", num_dense_features=13, num_sparse_features=NUM_SPARSE,
        embedding_dim=dim, bottom_mlp=(64, dim), top_mlp=(128, 64, 1),
    )
    table = TableConfig(
        dim=dim, capacity=1 << 20,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
    )
    run = RunConfig(batch_size=batch, steps=train_steps, seed=seed,
                    dense_learning_rate=1e-3, log_every=10**9)

    tr = Trainer(run, table, model)
    it = CriteoStream(tsv, batch_size=batch).batches(train_steps + eval_steps)
    for i in range(train_steps):
        tr.train_step(next(it))
    log(f"trained {train_steps} steps, train AUC {tr.auc.compute():.4f}")
    ck = tempfile.mkdtemp(prefix="meepo_srv_auc_")
    tr.save_checkpoint(ck)
    eval_batches = [next(it) for _ in range(eval_steps)]
    del tr

    out = {"metric": "serving_int8_auc_delta", "train_steps": train_steps}
    aucs = {}
    for mode in ("none", "int8"):
        svc = ScoringService(ck, table, model, quantize=mode)
        auc = StreamingAUC()
        for b in eval_batches:
            p = svc.score(b["dense"], b["ids"])
            auc.update(np.log(p / (1 - p) + 1e-12), np.asarray(b["label"]))
        aucs[mode] = float(auc.compute())
        log(f"{mode}: eval AUC {aucs[mode]:.5f}")
        del svc
    out["auc_f32"] = round(aucs["none"], 5)
    out["auc_int8"] = round(aucs["int8"], 5)
    out["delta"] = round(aucs["int8"] - aucs["none"], 5)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
