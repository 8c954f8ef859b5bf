import jax
import jax.numpy as jnp
import numpy as np

from meepoembedding_tpu.config import ModelConfig
from meepoembedding_tpu.models import build_model
from meepoembedding_tpu.models.common import bce_with_logits


def _cfg(kind):
    return ModelConfig(
        kind=kind,
        num_dense_features=4,
        num_sparse_features=3,
        embedding_dim=8,
        bottom_mlp=(16, 8),
        top_mlp=(16, 1),
    )


def test_shapes_and_grads():
    for kind in ("dlrm", "ctr_mlp", "dcn", "deepfm"):
        cfg = _cfg(kind)
        m = build_model(cfg)
        params = m.init(jax.random.PRNGKey(0))
        b = 5
        dense = jnp.ones((b, 4))
        emb = jnp.ones((b, 3, 8)) * 0.1
        logits = m.apply(params, dense, emb)
        assert logits.shape == (b,)
        y = jnp.array([0, 1, 0, 1, 1], jnp.float32)
        g = jax.grad(lambda p, e: bce_with_logits(m.apply(p, dense, e), y), argnums=(0, 1))(
            params, emb
        )
        leaves = jax.tree.leaves(g)
        assert all(np.isfinite(np.asarray(x)).all() for x in leaves)
        # embedding grads flow
        assert np.abs(np.asarray(g[1])).sum() > 0


def test_bce_matches_reference():
    z = jnp.array([-2.0, 0.0, 3.0])
    y = jnp.array([0.0, 1.0, 1.0])
    p = 1 / (1 + np.exp(-np.asarray(z)))
    expect = -np.mean(np.asarray(y) * np.log(p) + (1 - np.asarray(y)) * np.log(1 - p))
    np.testing.assert_allclose(float(bce_with_logits(z, y)), expect, rtol=1e-6)


def test_dlrm_interaction_symmetry():
    """Permuting sparse features only permutes interaction terms -> same set."""
    cfg = _cfg("dlrm")
    m = build_model(cfg)
    params = m.init(jax.random.PRNGKey(1))
    dense = jnp.zeros((1, 4))
    emb = jnp.asarray(np.random.default_rng(0).normal(size=(1, 3, 8)).astype(np.float32))
    l1 = m.apply(params, dense, emb)
    assert np.isfinite(np.asarray(l1)).all()


def test_dcn_cross_is_polynomial():
    """With zero deep/head nonlinearity interference, one cross layer of
    x0 * (Wx + b) + x produces exact degree-2 interactions: doubling x0
    quadruples the quadratic part. Sanity-check the cross recursion."""
    cfg = _cfg("dcn")
    m = build_model(cfg)
    params = m.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)
    dense = jnp.asarray(rng.normal(size=(2, 4)).astype(np.float32))
    emb = jnp.asarray(rng.normal(size=(2, 3, 8)).astype(np.float32))
    x0 = jnp.concatenate([dense, emb.reshape(2, -1)], axis=1)
    w, b = params["cross"][0]
    x1 = x0 * (x0 @ w + b) + x0
    x1_2 = (2 * x0) * ((2 * x0) @ w + b) + 2 * x0
    quad = x1 - x0 * b - x0          # quadratic part of x1
    quad2 = x1_2 - 2 * x0 * b - 2 * x0
    np.testing.assert_allclose(np.asarray(quad2), 4 * np.asarray(quad), rtol=1e-4)


def test_dcn_trains_e2e():
    """DCNv2 over the dynamic table lifts AUC above chance on the planted
    synthetic stream (config-1-style integration, SURVEY.md §4.6)."""
    from meepoembedding_tpu.config import RunConfig, TableConfig
    from meepoembedding_tpu.data.synthetic import SyntheticConfig, SyntheticStream
    from meepoembedding_tpu.train import train

    run = RunConfig(batch_size=256, steps=40, log_every=20, dense_learning_rate=3e-3)
    table = TableConfig(dim=8, capacity=1 << 14)
    model = ModelConfig(
        kind="dcn", num_dense_features=4, num_sparse_features=3,
        embedding_dim=8, top_mlp=(32, 1), num_cross_layers=2,
    )
    stream = SyntheticStream(SyntheticConfig(
        num_dense=4, num_sparse=3, batch_size=256, vocab_per_feature=500, seed=3,
    ))
    tr = train(run, table, model, stream)
    assert tr.auc.compute() > 0.54, tr.auc.compute()


def test_deepfm_fm_term_is_pairwise_sum():
    """FM identity: 0.5*((sum e)^2 - sum e^2) == sum_{i<j} <e_i, e_j>."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(4, 5, 8)).astype(np.float32)
    s = emb.sum(axis=1)
    fm = 0.5 * (np.sum(s * s, -1) - np.sum((emb * emb).sum(axis=1), -1))
    brute = np.zeros(4)
    for i in range(5):
        for j in range(i + 1, 5):
            brute += np.sum(emb[:, i] * emb[:, j], axis=-1)
    np.testing.assert_allclose(fm, brute, rtol=1e-4)


def test_deepfm_trains_e2e():
    from meepoembedding_tpu.config import RunConfig, TableConfig
    from meepoembedding_tpu.data.synthetic import SyntheticConfig, SyntheticStream
    from meepoembedding_tpu.train import train

    run = RunConfig(batch_size=256, steps=40, log_every=20, dense_learning_rate=3e-3)
    table = TableConfig(dim=8, capacity=1 << 14)
    model = ModelConfig(
        kind="deepfm", num_dense_features=4, num_sparse_features=3,
        embedding_dim=8, top_mlp=(32, 1),
    )
    stream = SyntheticStream(SyntheticConfig(
        num_dense=4, num_sparse=3, batch_size=256, vocab_per_feature=500, seed=3,
    ))
    tr = train(run, table, model, stream)
    assert tr.auc.compute() > 0.54, tr.auc.compute()


def test_bf16_tower_trains_all_models():
    """model.dtype=bfloat16: params/activations in bf16, f32 accumulate,
    f32 logits — every model family trains with finite loss."""
    from meepoembedding_tpu.config import RunConfig, TableConfig
    from meepoembedding_tpu.data.synthetic import SyntheticConfig, SyntheticStream
    from meepoembedding_tpu.train import train

    for kind in ("dlrm", "ctr_mlp", "dcn", "deepfm"):
        run = RunConfig(batch_size=64, steps=3, log_every=100)
        table = TableConfig(dim=8, capacity=1 << 12)
        model = ModelConfig(
            kind=kind, num_dense_features=4, num_sparse_features=3,
            embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(16, 1),
            dtype="bfloat16",
        )
        tr = train(run, table, model, SyntheticStream(SyntheticConfig(
            num_dense=4, num_sparse=3, batch_size=64, vocab_per_feature=200,
        )))
        leaves = jax.tree.leaves(tr.params)
        assert any(l.dtype == jnp.bfloat16 for l in leaves), kind
        assert np.isfinite(tr.auc.compute()), kind
