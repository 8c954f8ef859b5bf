"""Distributed online scoring (SURVEY.md L7 + C12/C13; README.md:2's serving
clause at the scale BASELINE.json:5 names — a 1B-row table physically cannot
fit one chip, so serving must span the mesh exactly like training does).

`ShardedScoringService` restores any elastic checkpoint (written with ANY
shard count) row-sharded over a `jax.sharding.Mesh` and scores request
batches through the probe-only all-to-all exchange
(`sharded_table.exchange_lookup(train=False)`): ids dedup locally, route to
their owner shard over the all-to-all, rows ride back, unknown ids contribute zero
embeddings, and every id that overflows the exchange capacity is COUNTED
(`route_drops` — a dropped id silently scores with a zero row, so serving
surfaces it in /metrics rather than hiding it).

The service is a drop-in for `serving.ScoringService` behind the same HTTP
front (`serving.make_http_server`): score / reload / stats / metrics_text
have identical signatures, so POST /score, POST /reload, GET /healthz and
GET /metrics all work unchanged — `meepo serve --http --distributed` wires
it up.

Scoring is jitted per input shape; request batches pad to the next power of
two AND to a multiple of the mesh size (each device scores B/S rows), so
ragged traffic compiles a bounded set of programs.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np


class ShardedScoringService:
    """Row-sharded, probe-only scoring over a device mesh."""

    def __init__(self, ckpt_path: str, table_cfg, model_cfg, mesh=None,
                 a2a_factor: float = 1.25):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from meepoembedding_tpu import checkpoint
        from meepoembedding_tpu.models import build_model
        from meepoembedding_tpu.parallel.mesh import SHARD_AXIS, make_mesh

        self.mesh = mesh or make_mesh()
        self.S = self.mesh.shape[SHARD_AXIS]
        self.table_cfg, self.model_cfg = table_cfg, model_cfg
        self.a2a_factor = a2a_factor
        self._ckpt_path = ckpt_path
        self.model = build_model(model_cfg)
        self._score_fns = {}
        self._lock = threading.Lock()
        self._lat_ms: list = []
        self._requests = 0
        self.route_drops = 0  # lifetime: ids scored with zero rows
        self.spec, self.stacked, self.params, self.manifest = self._restore(
            ckpt_path
        )

    # --- restore ------------------------------------------------------------
    def _restore(self, path: str):
        """Elastic restore onto the mesh: the checkpoint's live rows rehash
        to their owner shard (hash % S — any saved shard count reshards).
        Returns fresh (spec, stacked, params, manifest); caller swaps them in
        atomically so a hot reload never serves a half-restored table."""
        import dataclasses

        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from meepoembedding_tpu import checkpoint
        from meepoembedding_tpu.parallel.trainer import (
            alloc_stacked_shards, stacked_from_shards,
        )
        from meepoembedding_tpu.table.layout import TableSpec

        cfg = self.table_cfg
        total = sum(checkpoint.read_manifest(path).get("counts", [0]))
        spec = TableSpec.from_config(cfg, num_shards=self.S)
        # pre-grow a growable config to fit the checkpoint's live set (the
        # same policy DynamicEmbeddingTable.load applies single-device); a
        # fixed config that can't hold it raises in restore_shards — no
        # silent drop of rows
        while (
            cfg.grow_at_load is not None
            and total > cfg.grow_at_load * spec.capacity * self.S
        ):
            cfg = dataclasses.replace(cfg, capacity=cfg.capacity * 2)
            spec = TableSpec.from_config(cfg, num_shards=self.S)
        self.table_cfg = cfg

        template = alloc_stacked_shards(spec, self.mesh)
        my_ids = sorted(
            {s.index[0].start or 0 for s in template.cnt.addressable_shards}
        )
        shards, manifest = checkpoint.restore_shards(
            spec, path, self.S, only_ids=set(my_ids)
        )
        stacked = stacked_from_shards(
            {i: shards[i] for i in my_ids}, self.mesh, template
        )
        params = self.model.init(jax.random.PRNGKey(0))
        if "params" in manifest.get("dense", []):
            params = checkpoint.load_dense(path, "params", params)
        params = jax.device_put(params, NamedSharding(self.mesh, P()))
        return spec, stacked, params, manifest

    # --- scoring ------------------------------------------------------------
    def _score_fn(self, ids_shape):
        """Jitted shard_map scorer for one per-device ids geometry. Keyed on
        the GLOBAL ids shape + spec capacity (reload may regrow)."""
        import jax
        import jax.numpy as jnp
        from jax import lax
        from jax.sharding import PartitionSpec as P

        from meepoembedding_tpu.models.common import model_apply, model_inputs
        from meepoembedding_tpu.ops import dedup
        from meepoembedding_tpu.parallel import sharded_table as st
        from meepoembedding_tpu.parallel.mesh import SHARD_AXIS
        from meepoembedding_tpu.table import hashing

        key = (ids_shape, self.spec.capacity)
        fn = self._score_fns.get(key)
        if fn is not None:
            return fn
        spec, model, combiner = self.spec, self.model, self.model_cfg.combiner
        per_dev_ids = int(np.prod(ids_shape)) // self.S
        ucap = per_dev_ids
        cap = st.a2a_capacity(ucap, self.S, self.a2a_factor)

        def impl(stacked, params, dense, hi, lo):
            shard = st.squeeze_shard(stacked)
            uniq = dedup.unique_pairs(hi.reshape(-1), lo.reshape(-1), ucap)
            bag_valid = hashing.is_valid(hi, lo) if hi.ndim == 3 else None
            drops0 = shard.counters[st.ROUTE_DROPS]
            shard2, emb_u, _ = st.exchange_lookup(
                spec, shard, uniq.hi, uniq.lo, uniq.valid, jnp.int32(0),
                SHARD_AXIS, cap, train=False,
            )
            # probe-only: the shard itself is unchanged, but the drop count
            # must surface (VERDICT r2 weak-#4: zero-row scores are silent)
            drops = lax.psum(
                shard2.counters[st.ROUTE_DROPS] - drops0, SHARD_AXIS
            )
            emb = model_inputs(
                model, emb_u[uniq.inverse], hi, bag_valid, spec.dim, combiner
            )
            p = jax.nn.sigmoid(
                model_apply(model, params, dense, emb, bag_valid)
            )
            return p, drops

        sp = P(SHARD_AXIS)
        fn = jax.jit(jax.shard_map(
            impl, mesh=self.mesh,
            in_specs=(sp, P(), sp, sp, sp),
            out_specs=(sp, P()),
            check_vma=False,
        ))
        self._score_fns[key] = fn
        return fn

    def _pad_batch(self, dense: np.ndarray, ids: np.ndarray):
        """Pad B to a multiple of S that is a power of two (times S), so the
        per-device sub-batch is static across ragged request sizes. Padding
        rows carry the invalid-id sentinel and zero dense features; they are
        inert end to end and sliced off the reply."""
        from meepoembedding_tpu.table.hashing import EMPTY_ID

        b = len(dense)
        per = -(-b // self.S)  # ceil
        per = 1 << max(0, (per - 1).bit_length())
        bp = per * self.S
        if bp != b:
            dense = np.concatenate(
                [dense, np.zeros((bp - b,) + dense.shape[1:], np.float32)]
            )
            ids = np.concatenate(
                [ids, np.full((bp - b,) + ids.shape[1:], EMPTY_ID, np.int64)]
            )
        return dense, ids, b

    def score(self, dense: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """[B, ND] f32 + [B, S] or [B, S, L] int64 -> [B] probabilities,
        scored across the whole mesh."""
        from jax.sharding import PartitionSpec as P

        from meepoembedding_tpu.parallel import multihost
        from meepoembedding_tpu.parallel.mesh import SHARD_AXIS
        from meepoembedding_tpu.table import hashing

        dense = np.asarray(dense, np.float32)
        ids = np.asarray(ids, np.int64)
        t0 = time.perf_counter()
        with self._lock:
            dense, ids, b = self._pad_batch(dense, ids)
            hi, lo = hashing.split_ids(ids)
            sp = P(SHARD_AXIS)
            dense_g = multihost.shard_batch(dense, self.mesh, sp)
            hi_g = multihost.shard_batch(hi, self.mesh, sp)
            lo_g = multihost.shard_batch(lo, self.mesh, sp)
            fn = self._score_fn(tuple(ids.shape))
            p, drops = fn(self.stacked, self.params, dense_g, hi_g, lo_g)
            out = np.concatenate([
                np.asarray(s.data) for s in sorted(
                    p.addressable_shards,
                    key=lambda s: s.index[0].start or 0,
                )
            ])[:b]
            self.route_drops += int(drops)
            self._requests += 1
            self._lat_ms.append((time.perf_counter() - t0) * 1e3)
            if len(self._lat_ms) > 1024:
                del self._lat_ms[:512]
            return out

    @property
    def table(self):
        """RetrievalService reads rows via `scoring.table.lookup(ids,
        train=False)`; the mesh-sharded equivalent is this service itself."""
        return self

    def lookup(self, ids64: np.ndarray, train: bool = False) -> np.ndarray:
        """[n] int64 -> [n, dim] rows through the probe-only exchange
        (serving semantics: no insert-on-miss, absent ids return zero rows).
        Pads n to S * next_pow2(ceil(n/S)) so ragged request sizes compile a
        bounded set of programs."""
        assert not train, "sharded serving is probe-only"
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from meepoembedding_tpu.ops import dedup
        from meepoembedding_tpu.parallel import multihost
        from meepoembedding_tpu.parallel import sharded_table as st
        from meepoembedding_tpu.parallel.mesh import SHARD_AXIS
        from meepoembedding_tpu.table import hashing
        from meepoembedding_tpu.table.hashing import EMPTY_ID

        ids = np.asarray(ids64, np.int64).reshape(-1)
        n = len(ids)
        per = 1 << max(0, (-(-n // self.S) - 1).bit_length())
        npad = per * self.S
        ids_p = np.full((npad,), EMPTY_ID, np.int64)
        ids_p[:n] = ids
        hi, lo = hashing.split_ids(ids_p)
        key = ("rows", npad, self.spec.capacity)
        fn = self._score_fns.get(key)
        if fn is None:
            spec = self.spec
            ucap = per
            cap = st.a2a_capacity(ucap, self.S, self.a2a_factor)

            def impl(stacked, hi, lo):
                shard = st.squeeze_shard(stacked)
                uniq = dedup.unique_pairs(hi, lo, ucap)
                _, emb_u, _ = st.exchange_lookup(
                    spec, shard, uniq.hi, uniq.lo, uniq.valid, jnp.int32(0),
                    SHARD_AXIS, cap, train=False,
                )
                return emb_u[uniq.inverse]

            sp = P(SHARD_AXIS)
            fn = jax.jit(jax.shard_map(
                impl, mesh=self.mesh, in_specs=(sp, sp, sp),
                out_specs=sp, check_vma=False,
            ))
            self._score_fns[key] = fn
        sp = P(SHARD_AXIS)
        with self._lock:
            rows = fn(
                self.stacked,
                multihost.shard_batch(hi, self.mesh, sp),
                multihost.shard_batch(lo, self.mesh, sp),
            )
        out = np.concatenate([
            np.asarray(s.data) for s in sorted(
                rows.addressable_shards, key=lambda s: s.index[0].start or 0,
            )
        ])
        return out[:n]

    # --- lifecycle ----------------------------------------------------------
    def reload(self, ckpt_path: Optional[str] = None) -> dict:
        """Hot-swap to a (usually newer) checkpoint: the replacement table is
        fully restored onto the mesh OFF the serving lock — in-flight /score
        requests keep answering from the old state — then swapped atomically.
        Raises on a bad checkpoint, leaving the old state serving."""
        path = ckpt_path or self._ckpt_path
        spec, stacked, params, manifest = self._restore(path)
        with self._lock:
            self.spec, self.stacked = spec, stacked
            self.params, self.manifest = params, manifest
            self._ckpt_path = path
        return self.stats()

    def counters(self) -> dict:
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        c = np.asarray(jax.jit(
            lambda a: jnp.sum(a, axis=0),
            out_shardings=NamedSharding(self.mesh, P()),
        )(self.stacked.counters))
        names = [
            "hits", "misses", "inserts", "drops", "evictions", "spills",
            "promotes", "denied", "route_drops",
        ]
        out = {n: int(c[i]) for i, n in enumerate(names)}
        out["route_drops"] = max(out["route_drops"], self.route_drops)
        return out

    def __len__(self) -> int:
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        return int(jax.jit(
            jnp.sum, out_shardings=NamedSharding(self.mesh, P())
        )(self.stacked.cnt))

    def metrics_text(self) -> str:
        """Prometheus exposition format (same families as the single-device
        service, plus the mesh size and route drops)."""
        lines = [
            "# TYPE meepo_table_rows gauge",
            f"meepo_table_rows {len(self)}",
            "# TYPE meepo_mesh_devices gauge",
            f"meepo_mesh_devices {self.S}",
            "# TYPE meepo_requests_total counter",
            f"meepo_requests_total {self._requests}",
            "# TYPE meepo_route_drops_total counter",
            f"meepo_route_drops_total {self.route_drops}",
        ]
        for name, v in self.counters().items():
            if isinstance(v, (int, float)):
                lines.append(f"# TYPE meepo_table_{name}_total counter")
                lines.append(f"meepo_table_{name}_total {v}")
        if self._lat_ms:
            a = np.asarray(self._lat_ms)
            lines.append("# TYPE meepo_score_latency_ms summary")
            for q in (0.5, 0.95, 0.99):
                lines.append(
                    f'meepo_score_latency_ms{{quantile="{q}"}} '
                    f"{float(np.quantile(a, q)):.3f}"
                )
        return "\n".join(lines) + "\n"

    def stats(self) -> dict:
        return {
            "ok": True,
            "rows": len(self),
            "step": int(self.manifest.get("step", 0)),
            "dim": self.table_cfg.dim,
            "devices": self.S,
            "route_drops": self.route_drops,
        }
