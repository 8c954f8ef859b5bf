"""Model-zoo differentiation gate (VERDICT r4 missing #6).

The parity stream's unary planted signal scores every model family
identically — a DLRM regression that silently degraded its interaction term
would be invisible. This bench plants a LATENT-FACTOR pairwise signal
(write_synthetic_criteo_signal(interaction_scale=...)): feature pairs carry
hidden rank-r token factors whose dot products drive the label — exactly
what dot-interaction families (DLRM, DeepFM's FM term, DCN crosses) express
natively and a pure concat-MLP must memorize combinatorially. The gate is
that the interaction models MEASURABLY beat the wide MLP on held-out AUC:
a model-level regression now moves a number.

Prints one JSON line: eval AUC per model + the interaction gap.

Env: MEEPO_ZOO_LINES (train lines, default 192K), MEEPO_ZOO_BATCH (2048),
MEEPO_ZOO_VOCAB (2000/feature), MEEPO_ZOO_SEEDS (1).
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
    from meepoembedding_tpu.train import Trainer

    train_lines = int(os.environ.get("MEEPO_ZOO_LINES", 192_000))
    eval_lines = 32_000
    batch = int(os.environ.get("MEEPO_ZOO_BATCH", 2048))
    vocab = int(os.environ.get("MEEPO_ZOO_VOCAB", 800))
    seeds = int(os.environ.get("MEEPO_ZOO_SEEDS", 1))
    dim = 16
    total = train_lines + eval_lines

    tsv = os.path.join(
        tempfile.gettempdir(), f"meepo_zoo_{total}_{vocab}.tsv"
    )
    if not os.path.exists(tsv) or os.environ.get("MEEPO_ZOO_REGEN"):
        log(f"generating {total} interaction-signal lines ...")
        write_synthetic_criteo_signal(
            tsv, total, seed=11, vocab_per_feature=vocab,
            signal_scale=0.2, interaction_scale=2.5,
            interaction_rank=4, interaction_pairs=6,
        )
    train_steps, eval_steps = train_lines // batch, eval_lines // batch

    def model_cfg(kind):
        return ModelConfig(
            kind=kind, num_dense_features=13, num_sparse_features=NUM_SPARSE,
            embedding_dim=dim, bottom_mlp=(64, dim), top_mlp=(128, 64, 1),
            num_cross_layers=3,
        )

    results = {}
    for kind in ("dlrm", "deepfm", "dcn", "ctr_mlp"):
        aucs = []
        for seed in range(seeds):
            run = RunConfig(batch_size=batch, steps=train_steps, seed=seed,
                            dense_learning_rate=1e-3, log_every=10**9)
            table = TableConfig(
                dim=dim, capacity=1 << 18,
                optimizer=OptimizerConfig(kind="rowwise_adagrad",
                                          learning_rate=0.05),
            )
            tr = Trainer(run, table, model_cfg(kind))
            it = CriteoStream(tsv, batch_size=batch).batches(
                train_steps + eval_steps
            )
            for _ in range(train_steps):
                tr.train_step(next(it))
            ev = StreamingAUC()
            for _ in range(eval_steps):
                b = next(it)
                out = tr.eval_step(b)
                ev.update(np.asarray(out["logits"]), np.asarray(b["label"]))
            aucs.append(ev.compute())
            log(f"{kind} seed {seed}: eval AUC {aucs[-1]:.4f}")
        results[kind] = round(float(np.mean(aucs)), 5)

    # the gate: the BEST interaction-structured family must clear the wide
    # MLP by a visible margin (any family regression shrinks its own number)
    gap = max(results["dlrm"], results["deepfm"], results["dcn"]) - results["ctr_mlp"]
    print(json.dumps({
        "metric": "model_zoo_eval_auc_interaction_stream",
        **results,
        "interaction_gap_vs_mlp": round(float(gap), 5),
        "differentiates": bool(gap > 0.005),
    }))


if __name__ == "__main__":
    main()
