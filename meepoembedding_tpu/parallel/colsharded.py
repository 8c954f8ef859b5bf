"""Column-sharded (row x dim) distributed table — 2-D table parallelism
(SURVEY.md §2 "Column-sharding of dim"; HugeCTR-style row+column sharding).

Mesh is ('d', 'c'): axis `d` carries row-sharding + the all-to-all ID
exchange + data parallelism exactly as in `parallel/trainer.py`; axis `c`
splits the FEATURE dimension — column chip c holds lanes
[c*dim/C, (c+1)*dim/C) of every logical row.

The trick that makes this cheap: the key/metadata planes are kept
in lockstep across `c` BY DETERMINISM, not by collectives. probe /
plan_insert / admission are pure functions of (key planes, ids); every
column chip receives the identical id stream (batch replicated over `c`),
so their key-side state evolves bit-identically with ZERO communication on
`c`. Only value-like planes differ per column chip:

  - fresh rows: `TableSpec.init_lane_axis='c'` shifts the deterministic
    initializer's lane stream so concatenating the column blocks is
    bit-identical to an unsharded full-dim init (hashing.default_rows);
  - the ID all-to-all rides `d` within each column slice, and the row/grad
    payloads carry dim/C lanes per chip — exchange volume scales DOWN
    by C (the reason to column-shard very wide embeddings at all);
  - the dense tower all_gathers the [U, dim/C] blocks over `c` (feature-axis
    concat) outside the autodiff boundary; tower grads are computed
    replicated per column slice, and each chip slices out its own block —
    no collective in the sparse backward;
  - rowwise-AdaGrad's accumulator is a FULL-ROW statistic (mean over dim):
    the raw per-row sum of squares is psum'd over `c` and divided by the
    GLOBAL dim (optim.apply_sparse_grads_ctx g2_mean hook), so the
    accumulator stays bit-identical across column chips and semantically
    identical to the unsharded optimizer. Full-dim AdaGrad/Adam are
    per-lane and need no coupling.

The reference class (HugeCTR-style CUDA engines) implements column sharding
with NCCL all-gathers of value slices; here the only added collectives are
the feature all_gather and one [U]-scalar psum."""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from meepoembedding_tpu.config import ModelConfig, RunConfig, TableConfig
from meepoembedding_tpu.metrics import StreamingAUC
from meepoembedding_tpu.models import build_model
from meepoembedding_tpu.models.common import batch_item_key, model_inputs, model_loss
from meepoembedding_tpu.ops import dedup, optim
from meepoembedding_tpu.parallel import multihost
from meepoembedding_tpu.parallel import sharded_table as st
from meepoembedding_tpu.parallel.mesh import SHARD_AXIS
from meepoembedding_tpu.table import hashing
from meepoembedding_tpu.table.layout import TableSpec, alloc_shard

COL_AXIS = "c"


def make_mesh2d(num_row: int, num_col: int, devices=None) -> Mesh:
    """('d', 'c') mesh: `d` strides over device groups so each row slice is
    contiguous in device order (the a2a rides `d`; the cheap all_gather
    rides `c`)."""
    devs = list(devices if devices is not None else jax.devices())
    need = num_row * num_col
    assert len(devs) >= need, f"need {need} devices, have {len(devs)}"
    return Mesh(np.asarray(devs[:need]).reshape(num_row, num_col),
                (SHARD_AXIS, COL_AXIS))


def col_local_spec(spec: TableSpec, num_col: int) -> TableSpec:
    """Per-column-chip table geometry: dim/C lanes of every logical row."""
    assert spec.dim % num_col == 0, (spec.dim, num_col)
    return dataclasses.replace(
        spec, dim=spec.dim // num_col, init_lane_axis=COL_AXIS
    )


def alloc_col_stacked(spec_local: TableSpec, mesh: Mesh):
    """Empty shards stacked [S, C, ...], sharded over both mesh axes (the
    prototype is built inside the jit, as in trainer.alloc_stacked_shards)."""
    S, C = mesh.shape[SHARD_AXIS], mesh.shape[COL_AXIS]
    sharding = NamedSharding(mesh, P(SHARD_AXIS, COL_AXIS))

    @partial(jax.jit, out_shardings=sharding)
    def _alloc():
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a[None, None], (S, C) + a.shape),
            alloc_shard(spec_local),
        )

    return _alloc()


def addressable_shard_trees2(stacked) -> dict:
    """{(row-shard, column): host-numpy TableShard} for THIS process's
    devices (2-axis variant of trainer.addressable_shard_trees; zero-size
    leaves come out replicated and are indexed directly)."""
    leaves, treedef = jax.tree_util.tree_flatten(stacked)
    shard_data: list = [dict() for _ in leaves]
    my: set = set()
    for li, leaf in enumerate(leaves):
        for sh in leaf.addressable_shards:
            s0, c0 = sh.index[0].start, sh.index[1].start
            if s0 is None or c0 is None:  # replicated along a leading axis
                continue
            key = (int(s0), int(c0))
            my.add(key)
            shard_data[li][key] = np.asarray(sh.data)[0, 0]
    if not my and leaves and leaves[0].shape[0] == 1 and leaves[0].shape[1] == 1:
        # 1x1 mesh: the single shard reports full-axis slices (see
        # trainer.addressable_shard_trees)
        my = {(0, 0)}
    out = {}
    for key in sorted(my):
        vals = []
        for li, leaf in enumerate(leaves):
            if key in shard_data[li]:
                vals.append(shard_data[li][key])
            else:
                vals.append(np.asarray(leaf)[key[0], key[1]])
        out[key] = jax.tree_util.tree_unflatten(treedef, vals)
    return out


def stacked_from_shards2(shards_by_sc: dict, mesh, template_stacked):
    """Inverse of addressable_shard_trees2: per-(s,c) host pytrees -> one
    [S, C, ...] array pytree sharded over both mesh axes (each process
    contributes only its addressable entries)."""
    sharding = NamedSharding(mesh, P(SHARD_AXIS, COL_AXIS))
    leaves_t, treedef = jax.tree_util.tree_flatten(template_stacked)
    out_leaves = []
    for li, leaf_t in enumerate(leaves_t):
        gshape = leaf_t.shape
        dev_map = sharding.addressable_devices_indices_map(gshape)
        singles = []
        for dev, idx in dev_map.items():
            s = 0 if idx[0].start is None else int(idx[0].start)
            c = 0 if idx[1].start is None else int(idx[1].start)
            local = np.asarray(
                jax.tree_util.tree_leaves(shards_by_sc[(s, c)])[li]
            )[None, None]
            singles.append(jax.device_put(local, dev))
        out_leaves.append(
            jax.make_array_from_single_device_arrays(gshape, sharding, singles)
        )
    return jax.tree_util.tree_unflatten(treedef, out_leaves)


def _squeeze2(stacked):
    return jax.tree.map(lambda a: a[0, 0], stacked)


def _unsqueeze2(shard):
    return jax.tree.map(lambda a: a[None, None], shard)


def make_col_step(spec: TableSpec, model, mesh: Mesh, dense_lr: float,
                  unique_cap: int, a2a_factor: float = 1.25,
                  combiner: str = "mean", grad_clip_norm=None):
    """Jitted 2-D sharded train step. `spec` is the GLOBAL (full-dim)
    geometry; the table state is [S, C, ...] column-local shards."""
    S, C = mesh.shape[SHARD_AXIS], mesh.shape[COL_AXIS]
    spec_l = col_local_spec(spec, C)
    dl = spec_l.dim
    cap = st.a2a_capacity(unique_cap, S, a2a_factor)

    def g2_mean(s2):
        # full-row accumulator semantics: psum the raw sum-of-squares over
        # the column axis, divide by the GLOBAL dim
        return lax.psum(s2, COL_AXIS) / spec.dim

    def step_impl(stacked, params, opt_state, dense, hi, lo, label, step):
        shard = _squeeze2(stacked)
        uniq = dedup.unique_pairs(hi.reshape(-1), lo.reshape(-1), unique_cap)
        bag_valid = hashing.is_valid(hi, lo) if hi.ndim == 3 else None
        drops0 = shard.counters[st.ROUTE_DROPS]
        shard, emb_u, ctx = st.exchange_lookup(
            spec_l, shard, uniq.hi, uniq.lo, uniq.valid, step, SHARD_AXIS,
            cap, train=True,
        )
        drops = lax.psum(
            shard.counters[st.ROUTE_DROPS] - drops0, (SHARD_AXIS, COL_AXIS)
        ) // C
        # owner-side miss info (async cold-tier promotion feed): identical
        # across the column axis by lockstep; the host feeds column 0 only
        miss_out = tuple(
            a[None, None] for a in (ctx.miss_hi, ctx.miss_lo, ctx.miss)
        )
        # feature-axis all_gather OUTSIDE the autodiff boundary: tower grads
        # w.r.t. the gathered [U, dim] rows are computed replicated per
        # column slice; each chip then slices its own dim/C block — exact,
        # no scaling, no collective in the sparse backward.
        emb_full_u = lax.all_gather(
            emb_u.astype(jnp.float32), COL_AXIS, axis=1, tiled=True
        )  # [U, dim], block c at lanes [c*dl, (c+1)*dl)

        def loss_fn(params, emb_full_u):
            emb = model_inputs(
                model, emb_full_u[uniq.inverse], hi, bag_valid, spec.dim, combiner
            )
            loss, logits = model_loss(model, params, dense, emb, bag_valid, label,
                                      batch_item_key(model, hi, lo))
            return loss / S, logits

        (loss, logits), (g_dense, g_full) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True
        )(params, emb_full_u)
        cidx = lax.axis_index(COL_AXIS)
        g_u = lax.dynamic_slice_in_dim(g_full, cidx * dl, dl, axis=1)
        shard = st.exchange_apply_grads(
            spec_l, shard, ctx, g_u, SHARD_AXIS, cap, g2_mean=g2_mean
        )
        # dense grads are identical across `c` (replicated tower pass): psum
        # over `d` alone keeps them replicated on the full mesh
        g_dense = lax.psum(g_dense, SHARD_AXIS)
        if grad_clip_norm is not None:
            g_dense = optim.clip_by_global_norm(g_dense, grad_clip_norm)
        params, opt_state = optim.dense_adam_update(
            params, g_dense, opt_state, dense_lr
        )
        loss = lax.psum(loss, SHARD_AXIS)
        return (_unsqueeze2(shard), params, opt_state, loss, logits, drops,
                miss_out)

    sp2 = P(SHARD_AXIS, COL_AXIS)
    fn = jax.shard_map(
        step_impl,
        mesh=mesh,
        in_specs=(sp2, P(), P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                  P(SHARD_AXIS), P()),
        out_specs=(sp2, P(), P(), P(), P(SHARD_AXIS), P(), sp2),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


def make_col_eval(spec: TableSpec, model, mesh: Mesh, unique_cap: int,
                  a2a_factor: float = 1.25, combiner: str = "mean"):
    S, C = mesh.shape[SHARD_AXIS], mesh.shape[COL_AXIS]
    spec_l = col_local_spec(spec, C)
    cap = st.a2a_capacity(unique_cap, S, a2a_factor)

    def eval_impl(stacked, params, dense, hi, lo, label):
        shard = _squeeze2(stacked)
        uniq = dedup.unique_pairs(hi.reshape(-1), lo.reshape(-1), unique_cap)
        bag_valid = hashing.is_valid(hi, lo) if hi.ndim == 3 else None
        _, emb_u, _ = st.exchange_lookup(
            spec_l, shard, uniq.hi, uniq.lo, uniq.valid, jnp.int32(0),
            SHARD_AXIS, cap, train=False,
        )
        emb_full_u = lax.all_gather(
            emb_u.astype(jnp.float32), COL_AXIS, axis=1, tiled=True
        )
        emb = model_inputs(
            model, emb_full_u[uniq.inverse], hi, bag_valid, spec.dim, combiner
        )
        loss, logits = model_loss(model, params, dense, emb, bag_valid, label,
                                  batch_item_key(model, hi, lo))
        loss = lax.pmean(loss, SHARD_AXIS)
        return loss, logits

    fn = jax.shard_map(
        eval_impl,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS, COL_AXIS), P(), P(SHARD_AXIS), P(SHARD_AXIS),
                  P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=(P(), P(SHARD_AXIS)),
        check_vma=False,
    )
    return jax.jit(fn)


def make_promote_insert2(spec_l: TableSpec, mesh: Mesh, chunk: int):
    """Jitted 2-D bulk insert of promoted rows: each ROW shard receives its
    own owner-correct [chunk]-padded batch (replicated over the column
    axis), and each column chip writes only its dim/C lane block of the
    full-dim promoted rows — key planes stay in lockstep because every
    column runs the identical insert plan."""
    from meepoembedding_tpu.table import xla_ops
    from meepoembedding_tpu.table.layout import PROMOTES

    dl = spec_l.dim
    n_row = spec_l.optimizer.num_rowwise_slots()

    def impl(stacked, hi, lo, rows, valid, freq, accum, fulldim, step):
        shard = _squeeze2(stacked)
        cidx = lax.axis_index(COL_AXIS)
        rows_c = lax.dynamic_slice_in_dim(rows[0], cidx * dl, dl, axis=1)
        full_c = tuple(
            lax.dynamic_slice_in_dim(f[0], cidx * dl, dl, axis=1)
            for f in fulldim
        )
        shard, ok = xla_ops.insert_rows(
            spec_l, shard, hi[0], lo[0], rows_c, valid[0], step,
            freq=freq[0],
            accum=accum[0] if n_row else None,
            fulldim=full_c if full_c else None,
        )
        shard = shard._replace(
            counters=shard.counters.at[PROMOTES].add(
                jnp.sum(ok).astype(jnp.int32)
            )
        )
        return _unsqueeze2(shard)

    sp, sp2 = P(SHARD_AXIS), P(SHARD_AXIS, COL_AXIS)
    fn = jax.shard_map(
        impl,
        mesh=mesh,
        in_specs=(sp2, sp, sp, sp, sp, sp, sp, sp, P()),
        out_specs=sp2,
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


class ColShardedTrainer:
    """2-D (row x dim) sharded trainer for very wide embedding tables.
    Mirrors `parallel.trainer.ShardedTrainer`'s step API; table state is
    [S, C, ...] with column-local value planes."""

    def __init__(self, run_cfg: RunConfig, table_cfg: TableConfig,
                 model_cfg: ModelConfig, mesh: Mesh, spill=None):
        assert model_cfg.embedding_dim == table_cfg.dim
        self.mesh = mesh
        self.S = mesh.shape[SHARD_AXIS]
        self.C = mesh.shape[COL_AXIS]
        assert run_cfg.batch_size % self.S == 0
        self.run_cfg = run_cfg
        self.table_cfg = table_cfg
        self.spec = TableSpec.from_config(table_cfg, num_shards=self.S)
        self.spec_local = col_local_spec(self.spec, self.C)
        self.model = build_model(model_cfg)
        self.stacked = alloc_col_stacked(self.spec_local, mesh)
        key = jax.random.PRNGKey(run_cfg.seed)
        rep = NamedSharding(mesh, P())
        self.params = jax.device_put(self.model.init(key), rep)
        self.opt_state = jax.device_put(optim.dense_adam_init(self.params), rep)
        self.step = 0
        self.auc = StreamingAUC()
        from collections import deque

        # same host-fetch lag discipline as ShardedTrainer (pipeline_depth)
        self.pipeline_depth = max(0, run_cfg.pipeline_depth)
        self._pending: "deque" = deque()
        self._last = {"loss": None, "retired_step": None, "route_drops": 0}
        self._live_upper = 0
        per_dev_ids = run_cfg.batch_size // self.S * model_cfg.num_sparse_features
        self.unique_cap = run_cfg.unique_cap or per_dev_ids
        self._auto_ucap = run_cfg.unique_cap is None
        self._bag_len = 1
        self._model_cfg = model_cfg
        self._erase_fns = {}
        self.spill = spill
        self.spilled_rows = 0
        self._codec = None
        self._promoter = None
        self._promote_fn = None
        self._promote_chunk = 1024
        if spill is not None:
            # Cold-tier payloads are CANONICAL full-dim rows (the merged
            # column blocks), so the same backend serves any layout. Each
            # process must therefore hold every column of its row shards.
            assert jax.process_count() == 1, (
                "col-sharded spill/promotion is single-process: spilling "
                "merges all C column blocks of a row on one host"
            )
            from meepoembedding_tpu.tiering import PromotionEngine, SpillCodec

            self._codec = SpillCodec(self.spec)
            assert spill.width == self._codec.width, (
                f"spill backend width {spill.width} != full-dim codec "
                f"{self._codec.width}"
            )
            self._promoter = PromotionEngine(self._codec, spill)
        self._build_step_fns()

    def _device_batch(self, batch):
        hi, lo = hashing.split_ids(batch["ids"])
        ps = P(SHARD_AXIS)
        return (
            multihost.shard_batch(np.asarray(batch["dense"], np.float32), self.mesh, ps),
            multihost.shard_batch(hi, self.mesh, ps),
            multihost.shard_batch(lo, self.mesh, ps),
            multihost.shard_batch(np.asarray(batch["label"], np.float32), self.mesh, ps),
        )

    def _build_step_fns(self):
        self._step_fn = make_col_step(
            self.spec, self.model, self.mesh,
            self.run_cfg.dense_learning_rate, self.unique_cap,
            self.run_cfg.a2a_factor, self._model_cfg.combiner,
            grad_clip_norm=self.run_cfg.grad_clip_norm,
        )
        self._eval_fn = make_col_eval(
            self.spec, self.model, self.mesh, self.unique_cap,
            self.run_cfg.a2a_factor, self._model_cfg.combiner,
        )

    def _maybe_grow_ucap(self, ids: np.ndarray):
        """Same auto-rescale as ShardedTrainer: multi-hot batches carry L ids
        per feature; scale the dedup cap to the observed bag length."""
        L = ids.shape[2] if ids.ndim == 3 else 1
        if self._auto_ucap and L != self._bag_len:
            self._bag_len = L
            base = (self.run_cfg.batch_size // self.S
                    * self._model_cfg.num_sparse_features)
            self.unique_cap = base * L
            self._build_step_fns()

    def _maybe_grow(self, incoming: int) -> None:
        """Distributed online growth, 2-D: same lockstep doubling as
        ShardedTrainer._maybe_grow. Each (row, col) shard regrows LOCALLY;
        slot assignment is a deterministic function of the (identical) key
        planes, so columns stay in lockstep without any collective."""
        if self.table_cfg.grow_at_load is None:
            return
        # host-side upper bound gates the device fetch (see ShardedTrainer)
        limit = self.table_cfg.grow_at_load * self.spec.capacity * self.S
        self._live_upper += incoming
        if self._live_upper <= limit:
            return
        while True:
            # cnt is replicated across columns; sum over everything / C
            live = int(self._replicated(jnp.sum, self.stacked.cnt)) // self.C
            limit = self.table_cfg.grow_at_load * self.spec.capacity * self.S
            if (live + incoming) <= limit:
                self._live_upper = live + incoming
                return
            self.grow()

    def grow(self) -> None:
        import dataclasses as _dc

        from meepoembedding_tpu.table.runtime import regrow_shard

        old_local = self.spec_local
        self.table_cfg = _dc.replace(
            self.table_cfg, capacity=self.table_cfg.capacity * 2
        )
        self.spec = TableSpec.from_config(self.table_cfg, num_shards=self.S)
        self.spec_local = col_local_spec(self.spec, self.C)
        mine = addressable_shard_trees2(self.stacked)
        new_by_sc = {
            k: regrow_shard(old_local, self.spec_local, sh, self.step)
            for k, sh in mine.items()
        }
        self.stacked = stacked_from_shards2(
            new_by_sc, self.mesh, alloc_col_stacked(self.spec_local, self.mesh)
        )
        self._erase_fns = {}  # jits bind the old capacity
        self._promote_fn = None
        self._build_step_fns()

    def remove(self, ids64: np.ndarray) -> int:
        """Distributed explicit key removal on the 2-D layout
        (ShardedTrainer.remove's analog): ids route to their owner ROW
        shards over the a2a; every column shard erases the same slots in
        lockstep — key planes stay identical across 'c' by determinism and
        each column frees its own lane block. Returns the global count."""
        from meepoembedding_tpu.table.layout import LANES

        self.flush()  # in-flight steps bind (and donate) the current planes
        uniq = np.unique(np.asarray(ids64, np.int64))
        n = max(LANES, 1 << max(0, (len(uniq) - 1).bit_length()))
        ids = np.full((n,), hashing.EMPTY_ID, np.int64)
        ids[: len(uniq)] = uniq
        hi, lo = hashing.split_ids(ids)
        fn = self._erase_fns.get(n)
        if fn is None:
            spec_l = self.spec_local
            cap = st.a2a_capacity(n, self.S, self.run_cfg.a2a_factor)

            def impl(stacked, hi, lo):
                shard = _squeeze2(stacked)
                valid = hashing.is_valid(hi, lo)
                shard, removed = st.exchange_erase(
                    spec_l, shard, hi, lo, valid, SHARD_AXIS, cap
                )
                return _unsqueeze2(shard), removed

            fn = jax.jit(jax.shard_map(
                impl, mesh=self.mesh,
                in_specs=(P(SHARD_AXIS, COL_AXIS), P(), P()),
                out_specs=(P(SHARD_AXIS, COL_AXIS), P()),
                check_vma=False,
            ), donate_argnums=(0,))
            self._erase_fns[n] = fn
        self.stacked, removed = fn(self.stacked, jnp.asarray(hi), jnp.asarray(lo))
        return int(removed)

    def train_step(self, batch: dict) -> dict:
        self._maybe_grow_ucap(np.asarray(batch["ids"]))
        self._maybe_grow(
            np.asarray(batch["ids"]).size * max(1, jax.process_count())
        )
        dense, hi, lo, label = self._device_batch(batch)
        (self.stacked, self.params, self.opt_state, loss, logits, drops,
         miss) = self._step_fn(
            self.stacked, self.params, self.opt_state, dense, hi, lo, label,
            jnp.int32(self.step),
        )
        self.step += 1
        self._pending.append({
            "step": self.step - 1, "loss": loss, "drops": drops,
            "logits": logits, "labels": np.asarray(batch["label"]),
            "miss": miss,
        })
        while len(self._pending) > self.pipeline_depth:
            self._retire(self._pending.popleft())
        return dict(self._last, in_flight=len(self._pending))

    def _retire(self, ent: dict) -> None:
        """Host-side consumption of a completed step (lagged; never stalls
        the device pipeline — see ShardedTrainer._retire)."""
        if self._promoter is not None:
            # feed each row shard's owner-side misses once (column 0 only —
            # the miss planes are identical across the column axis)
            mh, ml, mm = ent["miss"]
            for shh, shl, shm in zip(
                mh.addressable_shards, ml.addressable_shards,
                mm.addressable_shards,
            ):
                if int(shh.index[1].start or 0) == 0:
                    self._promoter.feed(
                        shh.data[0, 0], shl.data[0, 0], shm.data[0, 0]
                    )
        logits = ent["logits"]
        # AUC over THIS process's slice: logits are replicated across the
        # column axis, so dedup addressable shards by batch-row start
        by_start = {}
        for sh in logits.addressable_shards:
            st0 = sh.index[0].start
            by_start.setdefault(0 if st0 is None else int(st0), np.asarray(sh.data))
        local_logits = np.concatenate([by_start[k] for k in sorted(by_start)])
        self.auc.update(local_logits, ent["labels"])
        self._last = {
            "loss": float(ent["loss"]),
            "retired_step": ent["step"],
            "route_drops": int(ent["drops"]),
        }

    def flush(self) -> list:
        """Retire every in-flight step; returns (step, loss) pairs."""
        out = []
        while self._pending:
            self._retire(self._pending.popleft())
            out.append((self._last["retired_step"], self._last["loss"]))
        return out

    def eval_step(self, batch: dict) -> dict:
        self._maybe_grow_ucap(np.asarray(batch["ids"]))
        dense, hi, lo, label = self._device_batch(batch)
        loss, logits = self._eval_fn(
            self.stacked, self.params, dense, hi, lo, label
        )
        return {"loss": float(loss), "logits": logits}

    def _apply_promotions(self) -> int:
        """Drain staged cold->hot promotions back into the 2-D table
        (SURVEY.md §3.4 reverse path): bucket full-dim payload rows by owner
        ROW shard, pad [chunk] rounds, run the 2-D insert — each column chip
        writes its own lane block of every promoted row."""
        if self._promoter is None:
            return 0
        out = self._promoter.drain()
        if out is None:
            return 0
        keys, state = out
        if not len(keys):
            return 0
        S, chunk, dim = self.S, self._promote_chunk, self.spec.dim
        hi_np, lo_np = hashing.split_ids(keys)
        owner = np.asarray(
            hashing.owner_of(jnp.asarray(hi_np), jnp.asarray(lo_np), S)
        )
        per = {s: np.nonzero(owner == s)[0] for s in range(S)}
        rounds = -(-max(len(v) for v in per.values()) // chunk)
        if self._promote_fn is None:
            self._promote_fn = make_promote_insert2(
                self.spec_local, self.mesh, chunk
            )
        n_full = self.spec.optimizer.num_fulldim_slots()
        n_row = self.spec.optimizer.num_rowwise_slots()
        sd = NamedSharding(self.mesh, P(SHARD_AXIS))
        promoted = 0
        for r in range(rounds):
            hi_b = np.full((S, chunk), hashing.EMPTY_HI, np.int32)
            lo_b = np.full((S, chunk), hashing.EMPTY_LO, np.int32)
            rows_b = np.zeros((S, chunk, dim), np.float32)
            valid_b = np.zeros((S, chunk), bool)
            freq_b = np.zeros((S, chunk), np.int32)
            accum_b = np.zeros((S, chunk), np.float32)
            full_b = [np.zeros((S, chunk, dim), np.float32)
                      for _ in range(n_full)]
            for s in range(S):
                idx = per[s][r * chunk : (r + 1) * chunk]
                k = len(idx)
                if not k:
                    continue
                hi_b[s, :k] = hi_np[idx]
                lo_b[s, :k] = lo_np[idx]
                rows_b[s, :k] = state["values"][idx]
                valid_b[s, :k] = True
                freq_b[s, :k] = state["freq"][idx]
                if n_row:
                    accum_b[s, :k] = state["accum"][idx]
                for j in range(n_full):
                    full_b[j][s, :k] = state["fulldim"][j][idx]
                promoted += k
            self.stacked = self._promote_fn(
                self.stacked,
                jax.device_put(hi_b, sd), jax.device_put(lo_b, sd),
                jax.device_put(rows_b, sd), jax.device_put(valid_b, sd),
                jax.device_put(freq_b, sd), jax.device_put(accum_b, sd),
                tuple(jax.device_put(f, sd) for f in full_b),
                jnp.int32(self.step),
            )
        # promoted rows are live rows the growth gate never counted
        self._live_upper += promoted
        return promoted

    def maintenance(self) -> dict:
        """Eviction/spill/promotion tick for the 2-D layout (SURVEY.md
        §3.4). evict_pass is a pure function of the key/score planes, which
        are identical across columns, so column shards evict the SAME rows
        in lockstep — each freeing its own lane block. With a spill backend
        the host merges the C lane blocks of every evicted row into one
        CANONICAL full-dim cold-tier payload (so any layout can restore
        it), and drains staged promotions back in."""
        self.flush()
        from meepoembedding_tpu.table import xla_ops

        promoted = self._apply_promotions()
        if self.spec.policy.evict_policy == "none":
            return {"evicted": 0, "promoted": promoted, "spilled": 0}
        spec_l = self.spec_local
        sp2 = P(SHARD_AXIS, COL_AXIS)
        evict = jax.shard_map(
            lambda stacked, step, off: jax.tree.map(
                lambda a: a[None, None],
                xla_ops.evict_pass(spec_l, _squeeze2(stacked), step, off),
            ),
            mesh=self.mesh,
            in_specs=(sp2, P(), P()),
            out_specs=sp2,
            check_vma=False,
        )
        off = getattr(self, "_evict_cursor", 0)
        self._evict_cursor = xla_ops.next_evict_cursor(spec_l, off)
        self.stacked, export = jax.jit(evict, donate_argnums=(0,))(
            self.stacked, jnp.int32(self.step), jnp.int32(off)
        )
        evicted = int(
            self._replicated(
                lambda c: jnp.sum(c[:, 0]), export.count
            )
        )
        spilled = 0
        if self.spill is not None and evicted:
            from meepoembedding_tpu.table.xla_ops import EvictExport
            from meepoembedding_tpu.tiering import spill_export

            by_s: dict = {}
            for (s, c), e in addressable_shard_trees2(export).items():
                by_s.setdefault(s, {})[c] = e
            for s, cols in sorted(by_s.items()):
                assert len(cols) == self.C, (
                    f"row shard {s}: only columns {sorted(cols)} addressable"
                )
                e0 = cols[0]
                n = int(e0.count)
                if not n:
                    continue
                rows = np.concatenate(
                    [np.asarray(cols[c].rows[:n], np.float32)
                     for c in range(self.C)], axis=1,
                )
                fulldim = tuple(
                    np.concatenate(
                        [np.asarray(cols[c].fulldim[j][:n], np.float32)
                         for c in range(self.C)], axis=1,
                    )
                    for j in range(len(e0.fulldim))
                )
                spilled += spill_export(self._codec, self.spill, EvictExport(
                    hi=np.asarray(e0.hi[:n]), lo=np.asarray(e0.lo[:n]),
                    rows=rows, freq=np.asarray(e0.freq[:n]),
                    accum=np.asarray(e0.accum[:n]), fulldim=fulldim,
                    count=np.int32(n),
                ))
            self.spilled_rows += spilled
        return {"evicted": evicted, "promoted": promoted, "spilled": spilled}

    # --- elastic checkpoint/restore (canonical full-dim format) -------------
    def save_checkpoint(self, path: str, extras: Optional[dict] = None) -> dict:
        """Write per-(shard, column) lane-block files; `checkpoint.iter_rows`
        merges them to full-dim rows, so the checkpoint restores onto ANY
        layout (single device / row-sharded / different (S, C) grid)."""
        from meepoembedding_tpu import checkpoint

        mine = addressable_shard_trees2(self.stacked)
        return checkpoint.save_sharded2d(
            path, self.spec_local, self.spec.dim, mine, self.S, self.C,
            self.step, extras=extras,
            dense={"params": self.params, "opt_state": self.opt_state},
            is_coordinator=jax.process_index() == 0,
            barrier=multihost.barrier,
        )

    def load_checkpoint(self, path: str) -> dict:
        """Elastic restore from ANY checkpoint layout: every key rehashes to
        its new owner row-shard; each column chip restores only its lane
        block (checkpoint.restore_shards lane_slice). A growable table
        (grow_at_load set) pre-grows to fit the checkpoint's live set, same
        as ShardedTrainer (advisor r3: restore used to raise instead)."""
        import dataclasses as _dc

        from meepoembedding_tpu import checkpoint

        total = sum(checkpoint.read_manifest(path).get("counts", [0]))
        grew = False
        while (
            self.table_cfg.grow_at_load is not None
            and total > self.table_cfg.grow_at_load * self.spec.capacity * self.S
        ):
            self.table_cfg = _dc.replace(
                self.table_cfg, capacity=self.table_cfg.capacity * 2
            )
            self.spec = TableSpec.from_config(self.table_cfg, num_shards=self.S)
            self.spec_local = col_local_spec(self.spec, self.C)
            grew = True
        if grew:
            self.stacked = alloc_col_stacked(self.spec_local, self.mesh)
            self._erase_fns = {}  # jits bind the pre-restore capacity
            self._promote_fn = None
            self._build_step_fns()

        sharding = NamedSharding(self.mesh, P(SHARD_AXIS, COL_AXIS))
        dev_map = sharding.addressable_devices_indices_map((self.S, self.C))
        mine = sorted({
            (int(i[0].start or 0), int(i[1].start or 0))
            for i in dev_map.values()
        })
        dl = self.spec_local.dim
        shards_by_sc = {}
        manifest = None
        for c in sorted({c for _, c in mine}):
            rows = {s for s, c2 in mine if c2 == c}
            shards, manifest = checkpoint.restore_shards(
                self.spec_local, path, self.S, only_ids=rows,
                lane_slice=(c * dl, dl),
            )
            for s in rows:
                shards_by_sc[(s, c)] = shards[s]
        self.stacked = stacked_from_shards2(
            shards_by_sc, self.mesh, self.stacked
        )
        rep = NamedSharding(self.mesh, P())
        self.params = jax.device_put(
            checkpoint.load_dense(path, "params", self.params), rep
        )
        self.opt_state = jax.device_put(
            checkpoint.load_dense(path, "opt_state", self.opt_state), rep
        )
        self.step = manifest["step"]
        # seed the growth gate with the restored live count (advisor r3 high:
        # an unseeded bound lets the table silently fill to hard capacity).
        self._live_upper = total
        return manifest

    def _replicated(self, fn, *arrs):
        return jax.jit(fn, out_shardings=NamedSharding(self.mesh, P()))(*arrs)

    def counters(self) -> dict:
        self.flush()
        # counters are identical across columns (lockstep): column 0, sum rows
        c = np.asarray(
            self._replicated(lambda a: jnp.sum(a[:, 0], axis=0), self.stacked.counters)
        )
        names = [
            "hits", "misses", "inserts", "drops", "evictions", "spills",
            "promotes", "denied", "route_drops",
        ]
        out = {n: int(c[i]) for i, n in enumerate(names)}
        # spill runs host-side; surface this process's merged-row count
        out["spills"] = max(out["spills"], self.spilled_rows)
        return out

    def __len__(self) -> int:
        return int(self._replicated(lambda a: jnp.sum(a[:, 0]), self.stacked.cnt))
