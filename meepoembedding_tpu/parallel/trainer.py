"""Distributed trainer (SURVEY.md C14/C18; BASELINE configs 3/5).

One jitted `shard_map` step over the 1-D mesh axis `d`:
  - batch sharded over `d` (data parallelism for the dense tower, C14);
  - one TableShard per device (row-sharded model parallelism, C12);
  - all-to-all ID/row/grad exchange inside the step (C13);
  - dense grads `pmean`ed over the mesh, identical dense update on every device.

Table state is stacked [S, ...] with a leading device axis sharded over `d`
and donated, so the 1B-row target never double-allocates.
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from meepoembedding_tpu.config import LANES, ModelConfig, RunConfig, TableConfig
from meepoembedding_tpu.metrics import JsonlLogger, Meter, StreamingAUC
from meepoembedding_tpu.models import build_model
from meepoembedding_tpu.models.common import batch_item_key, model_inputs, model_loss
from meepoembedding_tpu.ops import dedup, optim
from meepoembedding_tpu.parallel import multihost
from meepoembedding_tpu.parallel import sharded_table as st
from meepoembedding_tpu.parallel.mesh import SHARD_AXIS, make_mesh
from meepoembedding_tpu.table import hashing, xla_ops
from meepoembedding_tpu.table.layout import TableSpec, alloc_shard


def addressable_shard_trees(stacked) -> dict:
    """{global shard id: host-numpy TableShard} for THIS process's devices.
    Works single- and multi-process (SURVEY.md C19 save path / §3.4 spill).

    Zero-size leaves (e.g. a disabled cms plane) come out of jit REPLICATED —
    XLA normalizes shardings of empty arrays — so ids are derived from the
    genuinely sharded leaves and replicated leaves are indexed directly."""
    leaves, treedef = jax.tree_util.tree_flatten(stacked)
    shard_data: list = [dict() for _ in leaves]  # per leaf: {id: local data}
    my_ids: set = set()
    for li, leaf in enumerate(leaves):
        for sh in leaf.addressable_shards:
            start = sh.index[0].start
            if start is None:  # replicated along axis 0; resolve via my_ids
                continue
            i = int(start)
            my_ids.add(i)
            shard_data[li][i] = np.asarray(sh.data)[0]
    if not my_ids and leaves and leaves[0].shape[0] == 1:
        # a 1-shard mesh: XLA reports the single shard as a full-axis slice
        # (start None), which the loop above reads as "replicated" — but a
        # size-1 axis IS shard 0
        my_ids = {0}
    out = {}
    for i in sorted(my_ids):
        vals = []
        for li, leaf in enumerate(leaves):
            if i in shard_data[li]:
                vals.append(shard_data[li][i])
            else:  # replicated leaf: every process holds the full array
                vals.append(np.asarray(leaf)[i])
        out[i] = jax.tree_util.tree_unflatten(treedef, vals)
    return out


def stacked_from_shards(shards_by_id: dict, mesh, template_stacked):
    """Inverse of addressable_shard_trees: per-shard host pytrees -> one
    global stacked array pytree sharded over the mesh (multi-process safe:
    each process contributes only its addressable shards)."""
    sharding = NamedSharding(mesh, P(SHARD_AXIS))
    leaves_t, treedef = jax.tree_util.tree_flatten(template_stacked)
    out_leaves = []
    for li, leaf_t in enumerate(leaves_t):
        gshape = leaf_t.shape
        dev_map = sharding.addressable_devices_indices_map(gshape)
        singles = []
        for dev, idx in dev_map.items():
            i = idx[0].start
            i = 0 if i is None else int(i)
            local = np.asarray(
                jax.tree_util.tree_leaves(shards_by_id[i])[li]
            )[None]
            singles.append(jax.device_put(local, dev))
        out_leaves.append(
            jax.make_array_from_single_device_arrays(gshape, sharding, singles)
        )
    return jax.tree_util.tree_unflatten(treedef, out_leaves)


def make_sharded_step(spec: TableSpec, model, mesh, dense_lr: float, unique_cap: int,
                      a2a_factor: float = 1.25, combiner: str = "mean",
                      lr_schedule: str = "constant", total_steps: int = 0,
                      warmup_steps: int = 0, grad_clip_norm=None,
                      ragged: bool = False):
    """Build the jitted sharded train step. Batch arrays carry the GLOBAL
    batch on axis 0 (sharded over `d`); table state is stacked [S, ...].
    Also returns this step's global route_drops count so the trainer can
    auto-resize the exchange capacity if the hash balance is ever exceeded."""
    S = mesh.shape[SHARD_AXIS]
    if ragged:
        from meepoembedding_tpu.parallel import ragged as rg

        cap = rg.ragged_recv_cap(unique_cap, S, a2a_factor)
    else:
        cap = st.a2a_capacity(unique_cap, S, a2a_factor)

    # ragged exchange: owner-major dedup makes the step's one sort double as
    # the send-buffer compaction (the plan then skips its own [U] argsort).
    # FORCE_EXCHANGE (the S=1 overhead bench) prices the same slimmed plan.
    omaj = S if (ragged and (S > 1 or st.FORCE_EXCHANGE)) else 0

    def step_impl(stacked, params, opt_state, dense, hi, lo, label, step, logq):
        shard = st.squeeze_shard(stacked)
        uniq = dedup.unique_pairs(hi.reshape(-1), lo.reshape(-1), unique_cap,
                                  owner_major=omaj)
        bag_valid = hashing.is_valid(hi, lo) if hi.ndim == 3 else None
        drops0 = shard.counters[st.ROUTE_DROPS]
        shard, emb_u, ctx = st.exchange_lookup(
            spec, shard, uniq.hi, uniq.lo, uniq.valid, step, SHARD_AXIS, cap,
            train=True, ragged=ragged, owner_sorted=bool(omaj),
        )
        drops = lax.psum(shard.counters[st.ROUTE_DROPS] - drops0, SHARD_AXIS)
        # owner-side miss info, per shard (async cold-tier promotion feed)
        miss_out = tuple(a[None] for a in (ctx.miss_hi, ctx.miss_lo, ctx.miss))

        ikey = batch_item_key(model, hi, lo)

        def loss_fn(params, emb_u):
            emb = model_inputs(
                model, emb_u[uniq.inverse], hi, bag_valid, spec.dim, combiner
            )
            # 1/S so that grads carry GLOBAL-batch-mean scale: sparse grads
            # are psum'd on owners by construction, dense grads psum'd below.
            # Retrieval models (two_tower) draw in-batch negatives from the
            # LOCAL sub-batch — the standard DP convention (negatives stay
            # on-device; no gather of the global batch).
            # logq rides the batch sharding: correction against LOCAL
            # in-batch negatives, matching the local-negatives convention
            loss, logits = model_loss(model, params, dense, emb, bag_valid, label,
                                      ikey, logq=logq)
            return loss / S, logits

        (loss, logits), (g_dense, g_u) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True
        )(params, emb_u)
        shard = st.exchange_apply_grads(spec, shard, ctx, g_u, SHARD_AXIS, cap)
        g_dense = lax.psum(g_dense, SHARD_AXIS)
        if grad_clip_norm is not None:
            g_dense = optim.clip_by_global_norm(g_dense, grad_clip_norm)
        lr = optim.schedule_lr(lr_schedule, dense_lr, step,
                               max(total_steps, 1), warmup_steps)
        params, opt_state = optim.dense_adam_update(params, g_dense, opt_state, lr)
        loss = lax.psum(loss, SHARD_AXIS)
        return st.unsqueeze_shard(shard), params, opt_state, loss, logits, drops, miss_out

    shard_specs = P(SHARD_AXIS)
    fn = jax.shard_map(
        step_impl,
        mesh=mesh,
        in_specs=(shard_specs, P(), P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(), P(SHARD_AXIS)),
        out_specs=(shard_specs, P(), P(), P(), P(SHARD_AXIS), P(), P(SHARD_AXIS)),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


def make_sharded_eval(spec: TableSpec, model, mesh, unique_cap: int, a2a_factor: float = 1.25,
                      combiner: str = "mean", ragged: bool = False):
    S = mesh.shape[SHARD_AXIS]
    if ragged:
        from meepoembedding_tpu.parallel import ragged as rg

        cap = rg.ragged_recv_cap(unique_cap, S, a2a_factor)
    else:
        cap = st.a2a_capacity(unique_cap, S, a2a_factor)

    omaj = S if (ragged and (S > 1 or st.FORCE_EXCHANGE)) else 0

    def eval_impl(stacked, params, dense, hi, lo, label):
        shard = st.squeeze_shard(stacked)
        uniq = dedup.unique_pairs(hi.reshape(-1), lo.reshape(-1), unique_cap,
                                  owner_major=omaj)
        bag_valid = hashing.is_valid(hi, lo) if hi.ndim == 3 else None
        drops0 = shard.counters[st.ROUTE_DROPS]
        shard2, emb_u, _ = st.exchange_lookup(
            spec, shard, uniq.hi, uniq.lo, uniq.valid, jnp.int32(0), SHARD_AXIS, cap,
            train=False, ragged=ragged, owner_sorted=bool(omaj),
        )
        # the updated shard is discarded (eval mutates nothing), but the drop
        # count must NOT be: a dropped id silently scores with a zero row, so
        # the caller needs to know it happened (VERDICT r2 weak-#4)
        drops = lax.psum(shard2.counters[st.ROUTE_DROPS] - drops0, SHARD_AXIS)
        emb = model_inputs(
            model, emb_u[uniq.inverse], hi, bag_valid, spec.dim, combiner
        )
        loss, logits = model_loss(model, params, dense, emb, bag_valid, label,
                                  batch_item_key(model, hi, lo))
        loss = lax.pmean(loss, SHARD_AXIS)
        return loss, logits, drops

    fn = jax.shard_map(
        eval_impl,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=(P(), P(SHARD_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def make_promote_insert(spec: TableSpec, mesh, chunk: int):
    """Jitted per-shard bulk insert of promoted rows (SURVEY.md §3.4 reverse
    path, sharded): each device receives ITS OWN [chunk]-padded promotion
    batch (ids were observed as misses on that very shard, and owner routing
    is a pure hash, so the batch is owner-correct by construction)."""
    from meepoembedding_tpu.table.layout import PROMOTES

    def impl(stacked, hi, lo, rows, valid, freq, accum, fulldim, step):
        shard = st.squeeze_shard(stacked)
        shard, ok = xla_ops.insert_rows(
            spec, shard, hi[0], lo[0], rows[0], valid[0], step,
            freq=freq[0],
            accum=accum[0] if spec.optimizer.num_rowwise_slots() else None,
            fulldim=tuple(f[0] for f in fulldim) if fulldim else None,
        )
        # PROMOTES counts rows that actually LANDED; staged rows that lose
        # the slot race come back in `ok` so the caller can re-spill them to
        # the cold tier instead of silently dropping trained state
        # (VERDICT r4 weak #3).
        shard = shard._replace(
            counters=shard.counters.at[PROMOTES].add(jnp.sum(ok).astype(jnp.int32))
        )
        return st.unsqueeze_shard(shard), ok[None]

    sp = P(SHARD_AXIS)
    fn = jax.shard_map(
        impl,
        mesh=mesh,
        in_specs=(sp, sp, sp, sp, sp, sp, sp, sp, P()),
        out_specs=(sp, sp),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


def stacked_batch(mesh, per_shard_fn, shape_tail, dtype):
    """Per-shard host arrays -> one global [S, ...] array sharded over the
    mesh (multi-process safe: each process contributes only its shards)."""
    S = mesh.shape[SHARD_AXIS]
    sharding = NamedSharding(mesh, P(SHARD_AXIS))
    gshape = (S,) + tuple(shape_tail)
    dev_map = sharding.addressable_devices_indices_map(gshape)
    singles = []
    for dev, idx in dev_map.items():
        i = idx[0].start
        i = 0 if i is None else int(i)
        singles.append(
            jax.device_put(np.asarray(per_shard_fn(i), dtype)[None], dev)
        )
    return jax.make_array_from_single_device_arrays(gshape, sharding, singles)


class PromoteStats(NamedTuple):
    """Reconciled promotion accounting (VERDICT r4 weak #3): every staged row
    is either inserted into the hot tier or re-spilled to the cold tier —
    staged == inserted + respilled, nothing is silently dropped."""

    staged: int = 0
    inserted: int = 0
    respilled: int = 0


def drain_promotions(mesh, spec, stacked, promoter, promote_fn, chunk, step):
    """Drain one PromotionEngine into its owner shards: bucket the staged
    keys by owner, pad per-shard [chunk] rounds, run the jitted insert.
    Multi-process safe: every process executes the same number of insert
    rounds (agreed via all_processes_max), with empty padded batches where
    it has nothing. Rows that LOSE the slot race on their owner shard (table
    momentarily full) are re-inserted into the cold tier with their full
    payload, so trained state is never lost between tiers. Returns
    (stacked', PromoteStats). Shared by ShardedTrainer and
    ShardedGroupTrainer (per member table)."""
    S = mesh.shape[SHARD_AXIS]
    dim = spec.dim
    out = promoter.drain()
    keys, state = out if out is not None else (np.zeros((0,), np.int64), None)
    per = {s: np.zeros((0,), np.int64) for s in range(S)}
    if len(keys):
        hi_np, lo_np = hashing.split_ids(keys)
        owner = np.asarray(
            hashing.owner_of(jnp.asarray(hi_np), jnp.asarray(lo_np), S)
        )
        per = {s: np.nonzero(owner == s)[0] for s in range(S)}
    max_cnt = max((len(v) for v in per.values()), default=0)
    rounds = int(multihost.all_processes_max(-(-max_cnt // chunk)))
    if rounds == 0:
        return stacked, PromoteStats()
    n_full = spec.optimizer.num_fulldim_slots()
    n_row = spec.optimizer.num_rowwise_slots()
    staged_total = 0
    failed_idx = []  # global indices into `keys` that lost the slot race
    for r in range(rounds):
        inserted = [0]

        def rnd(s):
            return per[s][r * chunk : (r + 1) * chunk]

        def pad1(vals_fn, fill, s):
            idx = rnd(s)
            out = np.full((chunk,), fill)
            if len(idx):
                out[: len(idx)] = vals_fn(idx)
            return out

        def pad2(vals_fn, s):
            idx = rnd(s)
            out = np.zeros((chunk, dim))
            if len(idx):
                out[: len(idx)] = vals_fn(idx)
            return out

        hi_b = stacked_batch(
            mesh, lambda s: pad1(lambda i: hi_np[i], hashing.EMPTY_HI, s),
            (chunk,), np.int32,
        )
        lo_b = stacked_batch(
            mesh, lambda s: pad1(lambda i: lo_np[i], hashing.EMPTY_LO, s),
            (chunk,), np.int32,
        )
        rows_b = stacked_batch(
            mesh, lambda s: pad2(lambda i: state["values"][i], s), (chunk, dim),
            np.float32,
        )

        def vmask(s):
            n = len(rnd(s))
            inserted[0] += n
            v = np.zeros((chunk,), bool)
            v[:n] = True
            return v

        valid_b = stacked_batch(mesh, vmask, (chunk,), bool)
        freq_b = stacked_batch(
            mesh, lambda s: pad1(lambda i: state["freq"][i], 0, s), (chunk,),
            np.int32,
        )
        accum_b = stacked_batch(
            mesh,
            lambda s: pad1(lambda i: state["accum"][i], 0.0, s)
            if n_row else np.zeros((chunk,)),
            (chunk,), np.float32,
        )
        fulldim_b = tuple(
            stacked_batch(
                mesh, lambda s, j=j: pad2(lambda i: state["fulldim"][j][i], s),
                (chunk, dim), np.float32,
            )
            for j in range(n_full)
        )
        stacked, ok_b = promote_fn(
            stacked, hi_b, lo_b, rows_b, valid_b, freq_b, accum_b,
            fulldim_b, jnp.int32(step),
        )
        # Harvest THIS process's shards' ok masks (host fetch at maintenance
        # cadence, off the step path) and queue slot-race losers for
        # re-spill back to the cold tier.
        for sh in ok_b.addressable_shards:
            s = sh.index[0].start
            s = 0 if s is None else int(s)
            idx = rnd(s)
            if len(idx):
                ok_np = np.asarray(sh.data)[0][: len(idx)]
                if not ok_np.all():
                    failed_idx.append(idx[~ok_np])
        staged_total += inserted[0]
    respilled = 0
    if failed_idx and state is not None:
        from meepoembedding_tpu.tiering import respill_failed

        fi = np.concatenate(failed_idx)
        if len(fi):
            ok_mask = np.ones(len(keys), bool)
            ok_mask[fi] = False
            respilled = respill_failed(promoter, keys, state, ok_mask)
    return stacked, PromoteStats(
        staged=staged_total,
        inserted=staged_total - respilled,
        respilled=respilled,
    )


def alloc_stacked_shards(spec: TableSpec, mesh) -> "TableShard":
    """Empty per-device shards, stacked on a leading sharded axis. All shards
    start identical, so a broadcast placed with the right sharding suffices.
    The prototype is built inside the jit: an eager one would sit on the
    first device and be captured into the program as a constant."""
    S = mesh.shape[SHARD_AXIS]
    sharding = NamedSharding(mesh, P(SHARD_AXIS))

    @partial(jax.jit, out_shardings=sharding)
    def _alloc():
        return jax.tree.map(lambda a: jnp.broadcast_to(a[None], (S,) + a.shape),
                            alloc_shard(spec))

    return _alloc()


class ShardedTrainer:
    """Mirror of `train.Trainer` over a device mesh (BASELINE config 3)."""

    def __init__(
        self,
        run_cfg: RunConfig,
        table_cfg: TableConfig,
        model_cfg: ModelConfig,
        mesh=None,
        spill=None,
    ):
        assert model_cfg.embedding_dim == table_cfg.dim
        self.mesh = mesh or make_mesh()
        self.S = self.mesh.shape[SHARD_AXIS]
        assert run_cfg.batch_size % self.S == 0, "global batch must divide the mesh"
        self.run_cfg = run_cfg
        self.table_cfg = table_cfg
        self.spec = TableSpec.from_config(table_cfg, num_shards=self.S)
        self.model = build_model(model_cfg)
        self.stacked = alloc_stacked_shards(self.spec, self.mesh)
        key = jax.random.PRNGKey(run_cfg.seed)
        rep = NamedSharding(self.mesh, P())
        self.params = jax.device_put(self.model.init(key), rep)
        self.opt_state = jax.device_put(optim.dense_adam_init(self.params), rep)
        self.step = 0
        self.spill = spill
        self._codec = None
        self._promoter = None
        self._promote_fn = None
        self._promote_chunk = 1024
        if spill is not None:
            from meepoembedding_tpu.tiering import PromotionEngine, SpillCodec

            self._codec = SpillCodec(self.spec)
            assert spill.width == self._codec.width, (
                f"spill backend width {spill.width} != codec width {self._codec.width}"
            )
            self._promoter = PromotionEngine(self._codec, spill)
        self._freq_est = None
        if model_cfg.logq_correction:
            from meepoembedding_tpu.ops.itemfreq import ItemFrequencyEstimator

            assert hasattr(self.model, "loss_and_logits"), (
                "model.logq_correction needs a retrieval model (two_tower)"
            )
            self._freq_est = ItemFrequencyEstimator()
        self.auc = StreamingAUC()
        from collections import deque

        self.pipeline_depth = max(0, run_cfg.pipeline_depth)
        self._pending: "deque" = deque()
        self._last_loss = None
        self._last_step = None
        self._resized_at = -1
        self.eval_route_drops = 0
        self._live_upper = 0
        per_dev_ids = run_cfg.batch_size // self.S * model_cfg.num_sparse_features
        self.unique_cap = run_cfg.unique_cap or per_dev_ids
        self._auto_ucap = run_cfg.unique_cap is None
        self._bag_len = 1
        self.a2a_factor = run_cfg.a2a_factor
        self.a2a_ragged = run_cfg.a2a_ragged
        self.combiner = model_cfg.combiner
        self._erase_fns = {}
        self._build_step_fns()

    def _build_step_fns(self):
        self._step_fn = make_sharded_step(
            self.spec, self.model, self.mesh, self.run_cfg.dense_learning_rate,
            self.unique_cap, self.a2a_factor, self.combiner,
            lr_schedule=self.run_cfg.lr_schedule,
            total_steps=self.run_cfg.steps,
            warmup_steps=self.run_cfg.warmup_steps,
            grad_clip_norm=self.run_cfg.grad_clip_norm,
            ragged=self.a2a_ragged,
        )
        self._eval_fn = make_sharded_eval(
            self.spec, self.model, self.mesh, self.unique_cap, self.a2a_factor,
            self.combiner, ragged=self.a2a_ragged,
        )

    def _maybe_grow_ucap(self, ids: np.ndarray):
        """Multi-hot batches carry L ids per feature; the default dedup cap
        was sized for one. Scale it to the observed bag length (recompiles
        once per new L; an explicit run_cfg.unique_cap disables this)."""
        L = ids.shape[2] if ids.ndim == 3 else 1
        if self._auto_ucap and L != self._bag_len:
            self._bag_len = L
            base = self.run_cfg.batch_size // self.S * self.model.cfg.num_sparse_features
            self.unique_cap = base * L
            self._build_step_fns()

    def _device_batch(self, batch):
        """Per-process batch arrays -> global sharded arrays. In multi-process
        runs each host passes its LOCAL batch rows (global/num_processes) and
        the input pipeline shards lines per host (data/criteo.py)."""
        hi, lo = hashing.split_ids(batch["ids"])
        ps = P(SHARD_AXIS)
        return (
            multihost.shard_batch(np.asarray(batch["dense"], np.float32), self.mesh, ps),
            multihost.shard_batch(hi, self.mesh, ps),
            multihost.shard_batch(lo, self.mesh, ps),
            multihost.shard_batch(np.asarray(batch["label"], np.float32), self.mesh, ps),
        )

    def train_step(self, batch: dict) -> dict:
        """Dispatch one step. With run_cfg.pipeline_depth = d > 0 this method
        is HOST-SYNC-FREE in steady state: the step's scalars (loss, route
        drops) and arrays (logits, owner-side misses) are queued and only
        fetched d steps later, when their compute has long since finished —
        the same depth-lagged-fetch discipline bench.py proved necessary for
        honest throughput. The returned loss is therefore the loss of step
        `step - d` (None for the first d steps); call flush() to drain.
        d = 0 restores fully synchronous per-step semantics."""
        ids = np.asarray(batch["ids"])
        self._maybe_grow_ucap(ids)
        self._maybe_grow(ids.size * max(1, jax.process_count()))
        dense, hi, lo, label = self._device_batch(batch)
        if self._freq_est is not None:
            from meepoembedding_tpu.ops.itemfreq import item_keys_np

            lq = self._freq_est.update_and_logq(
                item_keys_np(ids, self.model.qf)
            )
        else:
            lq = np.zeros(len(ids), np.float32)  # subtracting 0 == no correction
        logq = multihost.shard_batch(lq, self.mesh, P(SHARD_AXIS))
        (
            self.stacked, self.params, self.opt_state, loss, logits, drops,
            miss_out,
        ) = self._step_fn(
            self.stacked, self.params, self.opt_state, dense, hi, lo, label,
            jnp.int32(self.step), logq,
        )
        self.step += 1
        self._pending.append({
            "step": self.step - 1,
            "loss": loss,
            "drops": drops,
            "logits": logits,
            "labels": np.asarray(batch["label"]),
            "miss": miss_out,
        })
        while len(self._pending) > self.pipeline_depth:
            self._retire(self._pending.popleft())
        return {"loss": self._last_loss, "retired_step": self._last_step,
                "in_flight": len(self._pending)}

    def _retire(self, ent: dict) -> None:
        """Consume one completed step's outputs on host. Runs depth steps
        after dispatch, so every fetch here is of an already-finished value
        and never stalls the device pipeline."""
        if self._promoter is not None:
            # feed THIS process's shards' misses; the worker thread fetches
            # and queries the cold tier off the step critical path
            mh, ml, mm = ent["miss"]
            for shh, shl, shm in zip(
                mh.addressable_shards, ml.addressable_shards, mm.addressable_shards
            ):
                self._promoter.feed(shh.data[0], shl.data[0], shm.data[0])
        if int(ent["drops"]) and ent["step"] >= self._resized_at:
            # Exchange capacity exceeded (astronomically unlikely under the
            # binomial hash balance, but possible for adversarial key sets):
            # the dropped ids trained from zero rows in that step; double the
            # factor so it cannot recur, rebuilding (recompiling) the step.
            # Steps already in flight when a resize fired still carry the old
            # capacity; their drops must not double the factor again
            # (_resized_at gates that).
            old = self.a2a_factor
            self.a2a_factor = min(self.a2a_factor * 2.0, float(self.S))
            import logging

            logging.getLogger(__name__).warning(
                "a2a exchange overflowed at step %d (%d ids trained from "
                "zero rows); a2a_factor %g -> %g, step recompiles",
                ent["step"], int(ent["drops"]), old, self.a2a_factor,
            )
            if self.a2a_factor != old:
                self._resized_at = self.step
                self._build_step_fns()
        # AUC over this process's slice of the batch (exact in single-process;
        # per-host streaming estimate in multi-process, aggregated at compute).
        logits = ent["logits"]
        shards = sorted(
            logits.addressable_shards,
            key=lambda s: s.index[0].start if s.index[0].start is not None else 0,
        )
        local_logits = np.concatenate([np.asarray(s.data) for s in shards])
        self.auc.update(local_logits, ent["labels"])
        self._last_loss = float(ent["loss"])
        self._last_step = ent["step"]

    def flush(self) -> list:
        """Retire every in-flight step (blocking). Returns the retired
        (step, loss) pairs, oldest first."""
        out = []
        while self._pending:
            self._retire(self._pending.popleft())
            out.append((self._last_step, self._last_loss))
        return out

    def eval_step(self, batch: dict) -> dict:
        self._maybe_grow_ucap(np.asarray(batch["ids"]))
        dense, hi, lo, label = self._device_batch(batch)
        loss, logits, drops = self._eval_fn(
            self.stacked, self.params, dense, hi, lo, label
        )
        drops = int(drops)
        self.eval_route_drops += drops
        if drops:
            import logging

            logging.getLogger(__name__).warning(
                "eval exchange dropped %d ids (scored with zero rows); raise "
                "run.a2a_factor", drops,
            )
        return {"loss": float(loss), "logits": logits, "route_drops": drops}

    def _maybe_grow(self, incoming: int) -> None:
        """Distributed online growth (SURVEY.md C11, sharded): when the
        GLOBAL live count could cross grow_at_load * global capacity this
        step, double every shard's capacity in lockstep. Owner routing is
        hash % S — independent of capacity — so rows stay on their shard;
        growth is S independent local rehashes, zero collectives.

        The device fetch of the live count would host-sync every step, so a
        host-side UPPER BOUND gates it: live can only grow by <= incoming ids
        per step, so the true count is fetched only when the running bound
        crosses the threshold (then reset to the fetched truth). Steps far
        from the growth point pay zero fetches."""
        if self.table_cfg.grow_at_load is None:
            return
        limit = self.table_cfg.grow_at_load * self.spec.capacity * self.S
        self._live_upper += incoming
        if self._live_upper <= limit:
            return
        while True:
            live = int(self._replicated(jnp.sum, self.stacked.cnt))
            limit = self.table_cfg.grow_at_load * self.spec.capacity * self.S
            if (live + incoming) <= limit:
                self._live_upper = live + incoming
                return
            self.grow()

    def grow(self) -> None:
        """Double per-shard capacity by local rehash on every shard."""
        import dataclasses

        from meepoembedding_tpu.table.runtime import regrow_shard

        old_spec = self.spec
        self.table_cfg = dataclasses.replace(
            self.table_cfg, capacity=self.table_cfg.capacity * 2
        )
        self.spec = TableSpec.from_config(self.table_cfg, num_shards=self.S)
        mine = addressable_shard_trees(self.stacked)
        new_by_id = {
            i: regrow_shard(old_spec, self.spec, sh, self.step)
            for i, sh in mine.items()
        }
        self.stacked = stacked_from_shards(
            new_by_id, self.mesh, alloc_stacked_shards(self.spec, self.mesh)
        )
        # every jitted fn binds the old spec geometry — rebuild
        self._erase_fns = {}
        self._promote_fn = None
        self._build_step_fns()

    def remove(self, ids64: np.ndarray) -> int:
        """Distributed explicit key removal (runtime.remove's sharded analog):
        ids route to their owner shards over the a2a; each key is erased on
        exactly one owner. Returns the global removed count. The (deduped)
        id list is replicated to every device — owner-side dedup collapses
        the S copies — so any process may call this with any id set."""
        uniq = np.unique(np.asarray(ids64, np.int64))
        n = max(LANES, 1 << max(0, (len(uniq) - 1).bit_length()))
        ids = np.full((n,), hashing.EMPTY_ID, np.int64)
        ids[: len(uniq)] = uniq
        hi, lo = hashing.split_ids(ids)
        fn = self._erase_fns.get(n)
        if fn is None:
            spec, mesh = self.spec, self.mesh
            cap = st.a2a_capacity(n, self.S, self.a2a_factor)

            def impl(stacked, hi, lo):
                shard = st.squeeze_shard(stacked)
                valid = hashing.is_valid(hi, lo)
                shard, removed = st.exchange_erase(
                    spec, shard, hi, lo, valid, SHARD_AXIS, cap
                )
                return st.unsqueeze_shard(shard), removed

            fn = jax.jit(jax.shard_map(
                impl, mesh=mesh,
                in_specs=(P(SHARD_AXIS), P(), P()),
                out_specs=(P(SHARD_AXIS), P()),
                check_vma=False,
            ), donate_argnums=(0,))
            self._erase_fns[n] = fn
        self.stacked, removed = fn(self.stacked, jnp.asarray(hi), jnp.asarray(lo))
        return int(removed)

    def _stacked_batch(self, per_shard_fn, shape_tail, dtype):
        return stacked_batch(self.mesh, per_shard_fn, shape_tail, dtype)

    def _apply_promotions(self) -> int:
        """Drain staged cold->hot promotions into their owner shards
        (SURVEY.md §3.4 reverse path). Runs at maintenance cadence, so
        promotion latency is the maintenance interval."""
        if self._promoter is None:
            return PromoteStats()
        if self._promote_fn is None:
            self._promote_fn = make_promote_insert(
                self.spec, self.mesh, self._promote_chunk
            )
        self.stacked, pst = drain_promotions(
            self.mesh, self.spec, self.stacked, self._promoter,
            self._promote_fn, self._promote_chunk, self.step,
        )
        # promotions add live rows outside train_step's incoming accounting;
        # bump the growth gate's upper bound by the GLOBAL INSERTED count so
        # _maybe_grow never undercounts (advisor r3 high finding). Re-spilled
        # rows went back to the cold tier, not into the table.
        self._live_upper += int(multihost.all_processes_sum(pst.inserted))
        self.promote_respills = (
            getattr(self, "promote_respills", 0) + pst.respilled
        )
        return pst

    def maintenance(self) -> dict:
        self.flush()  # drain pending retires (promoter feeds, drop checks)
        pst = self._apply_promotions()
        if not isinstance(pst, PromoteStats):
            pst = PromoteStats()
        if self.spec.policy.evict_policy == "none":
            return {"evicted": 0, "promoted": pst.inserted,
                    "promote_staged": pst.staged,
                    "promote_respilled": pst.respilled}
        evict = jax.shard_map(
            lambda stacked, step, off: jax.tree.map(
                lambda a: a[None],
                xla_ops.evict_pass(
                    self.spec, st.squeeze_shard(stacked), step, off
                ),
            ),
            mesh=self.mesh,
            in_specs=(P(SHARD_AXIS), P(), P()),
            out_specs=P(SHARD_AXIS),
            check_vma=False,
        )
        off = getattr(self, "_evict_cursor", 0)
        self._evict_cursor = xla_ops.next_evict_cursor(self.spec, off)
        self.stacked, export = jax.jit(evict, donate_argnums=(0,))(
            self.stacked, jnp.int32(self.step), jnp.int32(off)
        )
        # spill only THIS process's shards (multi-process safe host reads)
        local = addressable_shard_trees(export)
        total = sum(int(e.count) for e in local.values())
        if total and self.spill is not None:
            from meepoembedding_tpu.tiering import SpillCodec, spill_export

            codec = SpillCodec(self.spec)
            for e in local.values():
                spill_export(codec, self.spill, e)
            self.spilled_rows = getattr(self, "spilled_rows", 0) + total
        return {
            "evicted": int(multihost.all_processes_sum(total)),
            "promoted": pst.inserted,
            "promote_staged": pst.staged,
            "promote_respilled": pst.respilled,
        }

    # --- elastic checkpoint/restore (SURVEY.md C19; BASELINE config 5) -------
    def save_checkpoint(self, path: str, extras: Optional[dict] = None) -> dict:
        """Stream table shards + dense tower state to `path`. Multi-process
        safe: each process writes its OWN shards' files; process 0 commits the
        manifest after a barrier. Restorable onto a mesh of ANY size."""
        from meepoembedding_tpu import checkpoint

        self.flush()
        mine = addressable_shard_trees(self.stacked)
        manifest = checkpoint.save_sharded(
            path,
            self.spec,
            mine,
            self.S,
            self.step,
            extras=extras,
            dense={"params": self.params, "opt_state": self.opt_state},
            is_coordinator=jax.process_index() == 0,
            barrier=multihost.barrier,
        )
        return manifest

    def load_checkpoint(self, path: str) -> dict:
        """Elastic restore: a checkpoint written with N shards loads onto this
        trainer's S devices; every key is rehashed to its new owner shard.
        Multi-process safe: each process materializes only its own shards.
        A growable table (grow_at_load set) pre-grows to fit the checkpoint's
        live set; a fixed-capacity table that can't hold it raises (the
        restore never silently drops rows)."""
        import dataclasses

        from meepoembedding_tpu import checkpoint

        total = sum(checkpoint.read_manifest(path).get("counts", [0]))
        grew = False
        while (
            self.table_cfg.grow_at_load is not None
            and total > self.table_cfg.grow_at_load * self.spec.capacity * self.S
        ):
            self.table_cfg = dataclasses.replace(
                self.table_cfg, capacity=self.table_cfg.capacity * 2
            )
            self.spec = TableSpec.from_config(self.table_cfg, num_shards=self.S)
            grew = True
        if grew:
            self.stacked = alloc_stacked_shards(self.spec, self.mesh)
            self._erase_fns = {}
            self._promote_fn = None
            self._build_step_fns()

        sharding = NamedSharding(self.mesh, P(SHARD_AXIS))
        my_ids = sorted(
            {
                (idx[0].start if idx[0].start is not None else 0)
                for idx in sharding.addressable_devices_indices_map(
                    (self.S,)
                ).values()
            }
        )
        shards, manifest = checkpoint.restore_shards(
            self.spec, path, self.S, only_ids=set(my_ids)
        )
        self.stacked = stacked_from_shards(
            {i: shards[i] for i in my_ids}, self.mesh, self.stacked
        )
        rep = NamedSharding(self.mesh, P())
        self.params = jax.device_put(
            checkpoint.load_dense(path, "params", self.params), rep
        )
        self.opt_state = jax.device_put(
            checkpoint.load_dense(path, "opt_state", self.opt_state), rep
        )
        self.step = manifest["step"]
        # seed the growth gate with the restored live count: without this a
        # table restored near grow_at_load*capacity would not fetch the true
        # live count until sum(incoming) ALONE crossed the limit, filling to
        # hard capacity and silently denying inserts (advisor r3 high).
        self._live_upper = total
        return manifest

    def _replicated(self, fn, *arrs):
        """Reduce sharded arrays to a replicated (everywhere-addressable)
        result — the multi-process-safe way to read global state on host."""
        return jax.jit(fn, out_shardings=NamedSharding(self.mesh, P()))(*arrs)

    def counters(self) -> dict:
        self.flush()
        c = np.asarray(self._replicated(lambda a: jnp.sum(a, axis=0), self.stacked.counters))
        names = [
            "hits", "misses", "inserts", "drops", "evictions", "spills",
            "promotes", "denied", "route_drops",
        ]
        out = {n: int(c[i]) for i, n in enumerate(names)}
        from meepoembedding_tpu.table.layout import ERASES

        out["erases"] = int(c[ERASES])
        # spill runs host-side per process; surface this process's count
        out["spills"] = max(out["spills"], getattr(self, "spilled_rows", 0))
        # staged promotions that lost the slot race and went back to the
        # cold tier (staged == promotes + promote_respills, VERDICT r4 #3)
        out["promote_respills"] = getattr(self, "promote_respills", 0)
        return out

    def __len__(self) -> int:
        return int(self._replicated(jnp.sum, self.stacked.cnt))
