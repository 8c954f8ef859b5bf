"""CLI entry points (SURVEY.md C20/C21, L7): `train`, `eval`, `serve`,
`bench-lookup`, `bench-update`, `ckpt-inspect`, `ckpt-export`, `ckpt-import`
behind one argparse front end.

Config layering (C21): frozen-dataclass defaults <- YAML file (--config)
<- dotted CLI overrides (`--set table.capacity=1048576 run.steps=200`).

  python -m meepoembedding_tpu train --data synthetic --set run.steps=100
  python -m meepoembedding_tpu eval --ckpt /path/to/ckpt --data holdout.tsv
  python -m meepoembedding_tpu serve --ckpt /path/to/ckpt --distributed
  python -m meepoembedding_tpu bench-lookup --rows 1e6
  python -m meepoembedding_tpu ckpt-export /path/to/ckpt --out emb.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np

from meepoembedding_tpu.config import (
    ModelConfig,
    OptimizerConfig,
    PolicyConfig,
    RunConfig,
    TableConfig,
)


# --- config layering (C21) -----------------------------------------------------

def _coerce(value: str, field_type):
    import typing

    if field_type in (int, "int"):
        return int(float(value))  # allow 1e6
    if field_type in (float, "float"):
        return float(value)
    if field_type in (bool, "bool"):
        return value.lower() in ("1", "true", "yes")
    origin = typing.get_origin(field_type)
    if origin in (tuple, list):
        inner = typing.get_args(field_type)[0]
        return tuple(_coerce(v, inner) for v in value.split(",") if v != "")
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(field_type) if a is not type(None)]
        if value.lower() in ("none", "null", ""):
            return None
        return _coerce(value, args[0])
    return value


def _apply_overrides(cfg, overrides: dict):
    """Apply {dotted.path: value} onto a frozen dataclass, returning a copy."""
    direct = {}
    nested: dict = {}
    for k, v in overrides.items():
        head, _, rest = k.partition(".")
        if rest:
            nested.setdefault(head, {})[rest] = v
        else:
            direct[head] = v
    import typing

    fields = {f.name: f for f in dataclasses.fields(cfg)}
    hints = typing.get_type_hints(type(cfg))  # resolves string annotations
    updates = {}
    for k, v in direct.items():
        if k not in fields:
            raise KeyError(f"{type(cfg).__name__} has no field '{k}'")
        if isinstance(v, str):
            v = _coerce(v, hints.get(k, str))
        elif isinstance(v, list):  # YAML sequences -> tuple fields
            v = tuple(v)
        updates[k] = v
    for k, sub in nested.items():
        if k not in fields:
            raise KeyError(f"{type(cfg).__name__} has no field '{k}'")
        updates[k] = _apply_overrides(getattr(cfg, k), sub)
    return dataclasses.replace(cfg, **updates)


def _read_yaml(config_path: str) -> dict:
    """A --config file's mapping. PyYAML is needed only here."""
    try:
        import yaml
    except ImportError:
        raise SystemExit("--config needs PyYAML (pip install pyyaml)") from None
    with open(config_path) as f:
        return yaml.safe_load(f) or {}


def load_configs(
    config_path: Optional[str] = None, sets: Optional[list] = None
) -> tuple:
    """-> (RunConfig, TableConfig, ModelConfig) from defaults + YAML + --set."""
    layers = {"run": {}, "table": {}, "model": {}}
    if config_path:
        doc = _read_yaml(config_path)
        for section in layers:
            for k, v in (doc.get(section) or {}).items():
                layers[section][k] = v
    for item in sets or []:
        k, _, v = item.partition("=")
        if not _:
            raise ValueError(f"--set expects key=value, got '{item}'")
        section, _, rest = k.partition(".")
        if section not in layers:
            raise KeyError(f"--set section must be run/table/model, got '{section}'")
        layers[section][rest] = v

    return (
        _build_cfg(RunConfig, layers["run"]),
        _build_cfg(TableConfig, layers["table"]),
        _build_cfg(ModelConfig, layers["model"]),
    )


def _build_cfg(cls, d: dict):
    """Nested field dict -> frozen config dataclass (shared by the run/table/
    model sections and the per-table entries of a `tables:` group config)."""
    flat = {}

    def flatten(prefix, dd):
        for k, v in dd.items():
            if isinstance(v, dict):
                flatten(f"{prefix}{k}.", v)
            else:
                flat[f"{prefix}{k}"] = v

    flatten("", d)
    return _apply_overrides(cls(), flat)


def load_group_configs(config_path: Optional[str], sets: Optional[list] = None):
    """Heterogeneous multi-table training config (group_train.GroupTrainer).

    Returns (run_cfg, {name: TableConfig}, feature_map, model_cfg) when the
    YAML carries a `tables:` section, else None:

        tables:
          user: {dim: 64, capacity: 4194304, optimizer: {kind: rowwise_adagrad}}
          item: {dim: 32, capacity: 1048576}
        feature_map: [user, item, item]   # sparse column -> table
        run: {...}   model: {...}         # the normal sections

    `--set run.* / model.*` overrides apply as usual (`--set table.*` is the
    single-table section and is rejected here to avoid silent no-ops)."""
    if not config_path:
        return None
    doc = _read_yaml(config_path)
    if "tables" not in doc:
        return None
    if any(item.partition("=")[0].startswith("table.") for item in sets or []):
        raise SystemExit(
            "--set table.* does not apply to a `tables:` group config; "
            "set per-table fields in the YAML"
        )
    feature_map = doc.get("feature_map")
    if not feature_map:
        raise SystemExit("`tables:` config needs a `feature_map:` list")
    run_cfg, _, model_cfg = load_configs(config_path, sets)
    tables = {
        name: _build_cfg(TableConfig, dict(spec or {}))
        for name, spec in doc["tables"].items()
    }
    if model_cfg.num_sparse_features != len(feature_map):
        model_cfg = dataclasses.replace(
            model_cfg, num_sparse_features=len(feature_map)
        )
    return run_cfg, tables, list(feature_map), model_cfg


def _make_spill(args, table_cfg):
    if not getattr(args, "spill", None) or args.spill == "none":
        return None
    from meepoembedding_tpu.backends import make_backend
    from meepoembedding_tpu.table.layout import TableSpec
    from meepoembedding_tpu.tiering import SpillCodec

    spec = TableSpec.from_config(table_cfg)
    kwargs = {}
    if args.spill == "disk":
        kwargs["path"] = args.spill_path or "/tmp/meepo_spill.log"
    if args.spill == "redis":
        kwargs["host"], _, port = (args.spill_addr or "127.0.0.1:6379").partition(":")
        kwargs["port"] = int(port or 6379)
    return make_backend(args.spill, width=SpillCodec(spec).width, **kwargs)


def _make_group_spill(args, tables: dict):
    """Per-table spill backends for `tables:` group training. host/disk only:
    a shared redis keyspace would collide across tables (raw int64 keys with
    table-specific row widths)."""
    if not getattr(args, "spill", None) or args.spill == "none":
        return None
    if args.spill == "redis":
        raise SystemExit(
            "`tables:` group training supports --spill host|disk (one redis "
            "keyspace cannot hold several tables' different row widths)"
        )
    from meepoembedding_tpu.backends import make_backend
    from meepoembedding_tpu.table.layout import TableSpec
    from meepoembedding_tpu.tiering import SpillCodec

    out = {}
    for name, cfg in tables.items():
        kwargs = {}
        if args.spill == "disk":
            base = args.spill_path or "/tmp/meepo_spill.log"
            kwargs["path"] = f"{base}.{name}"
        spec = TableSpec.from_config(cfg)
        out[name] = make_backend(args.spill, width=SpillCodec(spec).width, **kwargs)
    return out


# --- subcommands ----------------------------------------------------------------

def _expand_paths(data: str):
    """Comma-separated paths with glob support (Criteo Terabyte day-files:
    --data 'day_*.gz'). Order is sorted within each pattern for determinism;
    a pattern matching nothing is a hard error (silent empty input hides
    typos)."""
    import glob as _glob

    out = []
    for p in data.split(","):
        if any(ch in p for ch in "*?["):
            hits = sorted(_glob.glob(p))
            if not hits:  # not assert: must survive python -O
                raise ValueError(f"--data pattern matched no files: {p}")
            out.extend(hits)
        else:
            out.append(p)
    return out


def make_train_stream(data: str, run_cfg, model_cfg, host_id: int, num_hosts: int,
                      bag_len: int = 1):
    """Multi-host data sharding (SURVEY.md C17): each process reads a DISJOINT
    slice of the input. For Criteo this is line-level host sharding; the
    synthetic stream decorrelates by seed. Single-process runs are
    unaffected (host 0 of 1)."""
    if data == "synthetic":
        from meepoembedding_tpu.data.synthetic import SyntheticConfig, SyntheticStream

        return SyntheticStream(SyntheticConfig(
            batch_size=run_cfg.batch_size,
            num_sparse=model_cfg.num_sparse_features,
            num_dense=model_cfg.num_dense_features,
            seed=run_cfg.seed + host_id,
            bag_len=bag_len,
        ))
    from meepoembedding_tpu.data.criteo import CriteoStream
    from meepoembedding_tpu.data.prefetch import PrefetchStream

    # file-backed input: overlap parse (GIL-free native) with device steps
    return PrefetchStream(CriteoStream(
        _expand_paths(data), batch_size=run_cfg.batch_size, loop=True,
        host_id=host_id, num_hosts=num_hosts,
    ))


def _train_group(args, run_cfg, tables, feature_map, model_cfg) -> int:
    """Heterogeneous multi-table training behind the same `train` front end,
    selected by a `tables:` YAML section. --distributed row-shards every
    member table over the mesh (group_train.ShardedGroupTrainer). --spill
    host|disk gives every member its own spill backend; --maintenance-every
    runs each member's eviction/spill tick on its own rotating cursor."""
    spill = _make_group_spill(args, tables)
    import jax

    from meepoembedding_tpu.group_train import GroupTrainer, ShardedGroupTrainer
    from meepoembedding_tpu.metrics import JsonlLogger, Meter

    stream = make_train_stream(
        args.data, run_cfg, model_cfg, jax.process_index(), jax.process_count(),
        bag_len=args.bag_len,
    )
    if args.distributed:
        from meepoembedding_tpu.parallel.mesh import make_mesh

        mesh = None
        if run_cfg.mesh_shape:
            n = run_cfg.mesh_shape[0]
            assert n <= jax.device_count(), (
                f"run.mesh_shape={run_cfg.mesh_shape} needs {n} devices, "
                f"have {jax.device_count()}"
            )
            mesh = make_mesh(n)
        tr = ShardedGroupTrainer(run_cfg, tables, feature_map, model_cfg,
                                 mesh=mesh, spill=spill)
    else:
        tr = GroupTrainer(run_cfg, tables, feature_map, model_cfg, spill=spill)
    if args.restore:
        tr.load_checkpoint(args.restore)
    logger = JsonlLogger(echo=True)
    loss_m = Meter()
    t0 = time.perf_counter()
    examples = 0
    for i, batch in enumerate(stream.batches(run_cfg.steps)):
        out = tr.train_step(batch)
        if out["loss"] is not None:  # sharded trainer lags pipeline_depth
            loss_m.update(out["loss"])
        examples += len(batch["label"])
        if (i + 1) % run_cfg.log_every == 0:
            logger.log(
                step=tr.step, loss=loss_m.mean, auc=tr.auc.compute(),
                examples_per_sec=examples / (time.perf_counter() - t0),
                rows={n: c["rows"] for n, c in tr.counters().items()},
            )
        if args.maintenance_every and (i + 1) % args.maintenance_every == 0:
            tr.maintenance()
        if args.ckpt_dir and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            tr.save_checkpoint(args.ckpt_dir)
    if hasattr(tr, "flush"):
        for _s, l in tr.flush():
            loss_m.update(l)
    if args.ckpt_dir:
        tr.save_checkpoint(args.ckpt_dir)
    print(json.dumps({"final_auc": tr.auc.compute(), "steps": tr.step}))
    return 0


def cmd_train(args) -> int:
    import jax

    grp = load_group_configs(args.config, args.set)
    if grp is not None:
        return _train_group(args, *grp)
    run_cfg, table_cfg, model_cfg = load_configs(args.config, args.set)
    model_cfg = dataclasses.replace(model_cfg, embedding_dim=table_cfg.dim)
    stream = make_train_stream(
        args.data, run_cfg, model_cfg, jax.process_index(), jax.process_count(),
        bag_len=args.bag_len,
    )

    spill = _make_spill(args, table_cfg)
    prof = None
    if run_cfg.profile_dir:
        jax.profiler.start_trace(run_cfg.profile_dir)
        prof = run_cfg.profile_dir

    try:
        if args.distributed and jax.device_count() > 1:
            from meepoembedding_tpu.metrics import JsonlLogger, Meter
            from meepoembedding_tpu.parallel.trainer import ShardedTrainer

            col = getattr(args, "col_shards", 1)
            if col > 1:
                # 2-D (row x dim) table parallelism for very wide tables
                from meepoembedding_tpu.parallel.colsharded import (
                    ColShardedTrainer, make_mesh2d,
                )

                assert jax.device_count() % col == 0, (
                    f"--col-shards {col} must divide {jax.device_count()} devices"
                )
                mesh = make_mesh2d(jax.device_count() // col, col)
                tr = ColShardedTrainer(run_cfg, table_cfg, model_cfg, mesh,
                                       spill=spill)
            else:
                # run.mesh_shape=(N,) restricts the 1-D shard mesh to the
                # first N local devices (default: all of them)
                mesh = None
                if run_cfg.mesh_shape:
                    from meepoembedding_tpu.parallel.mesh import make_mesh

                    n = int(np.prod(run_cfg.mesh_shape))
                    assert n <= jax.device_count(), (
                        f"run.mesh_shape={run_cfg.mesh_shape} needs {n} devices, "
                        f"have {jax.device_count()}"
                    )
                    mesh = make_mesh(n)
                tr = ShardedTrainer(run_cfg, table_cfg, model_cfg, spill=spill,
                                    mesh=mesh)
            if args.restore:
                tr.load_checkpoint(args.restore)
            logger = JsonlLogger(echo=True)
            loss_m = Meter()
            t0 = time.perf_counter()
            examples = 0
            eval_iter = None
            if run_cfg.eval_every:
                # held-out stream, decorrelated seed (same as single-device)
                eval_iter = make_train_stream(
                    args.data, dataclasses.replace(run_cfg, seed=run_cfg.seed + 7919),
                    model_cfg, jax.process_index(), jax.process_count(),
                    bag_len=args.bag_len,
                ).batches(run_cfg.steps)
            for i, batch in enumerate(stream.batches(run_cfg.steps)):
                out = tr.train_step(batch)
                # pipelined trainer: loss is lagged by run.pipeline_depth
                # steps and None while the pipe fills
                if out["loss"] is not None:
                    loss_m.update(out["loss"])
                examples += len(batch["label"])
                if args.maintenance_every and (i + 1) % args.maintenance_every == 0:
                    tr.maintenance()
                if eval_iter is not None and (i + 1) % run_cfg.eval_every == 0:
                    try:
                        eb = next(eval_iter)
                    except StopIteration:
                        eval_iter = None
                    else:
                        ev = tr.eval_step(eb)
                        from meepoembedding_tpu.metrics import StreamingAUC

                        logits = ev["logits"]
                        if hasattr(logits, "addressable_shards"):
                            logits = np.concatenate([
                                np.asarray(s.data) for s in sorted(
                                    logits.addressable_shards,
                                    key=lambda s: s.index[0].start or 0,
                                )
                            ])
                        ea = StreamingAUC()
                        ea.update(np.asarray(logits), np.asarray(eb["label"]))
                        logger.log(step=tr.step, eval_loss=ev["loss"],
                                   eval_auc=ea.compute())
                if (i + 1) % run_cfg.log_every == 0:
                    logger.log(
                        step=tr.step, loss=loss_m.mean, auc=tr.auc.compute(),
                        examples_per_sec=examples / (time.perf_counter() - t0),
                        rows=len(tr), **tr.counters(),
                    )
                if args.ckpt_dir and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
                    tr.save_checkpoint(args.ckpt_dir)
            for _s, l in tr.flush():
                loss_m.update(l)
            if args.ckpt_dir:
                tr.save_checkpoint(args.ckpt_dir)
        else:
            from meepoembedding_tpu.train import Trainer, train

            if args.restore:
                tr = Trainer(run_cfg, table_cfg, model_cfg, spill=spill)
                tr.load_checkpoint(args.restore)
                from meepoembedding_tpu.metrics import Meter

                loss_m = Meter()
                for i, batch in enumerate(stream.batches(run_cfg.steps)):
                    loss_m.update(tr.train_step(batch)["loss"])
                    if args.maintenance_every and (i + 1) % args.maintenance_every == 0:
                        tr.maintenance()
            else:
                eval_stream = None
                if run_cfg.eval_every:
                    # held-out stream: same source, decorrelated seed
                    import dataclasses as _dc

                    eval_stream = make_train_stream(
                        args.data, _dc.replace(run_cfg, seed=run_cfg.seed + 7919),
                        model_cfg, jax.process_index(), jax.process_count(),
                        bag_len=args.bag_len,
                    )
                tr = train(
                    run_cfg, table_cfg, model_cfg, stream,
                    maintenance_every=args.maintenance_every, spill=spill,
                    eval_stream=eval_stream,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                )
            if args.ckpt_dir:
                tr.save_checkpoint(args.ckpt_dir)
        print(json.dumps({"final_auc": tr.auc.compute(), "steps": tr.step}))
    finally:
        if prof:
            jax.profiler.stop_trace()
    return 0


def _bench_table(args, update: bool) -> int:
    import jax
    import jax.numpy as jnp

    from meepoembedding_tpu.device import bench_device, describe
    from meepoembedding_tpu.ops import dedup, optim
    from meepoembedding_tpu.table import hashing, xla_ops
    from meepoembedding_tpu.table.layout import TableSpec, alloc_shard

    from functools import partial

    dev = bench_device()
    rows = int(float(args.rows))
    batch = int(float(args.batch))
    # same methodology as the headline bench.py: pair probing, insert-cap
    # admission, Zipf(1.05) id stream, dedup capacity sized to its ~35%
    # unique rate — so this user-facing bench reads within a few percent of
    # the recorded headline numbers (VERDICT r1 weak-#7)
    cfg = TableConfig(
        dim=args.dim, capacity=rows,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
        max_probe_rounds=2,
        insert_cap=1 << 15,
    )
    spec = TableSpec.from_config(cfg)
    shard = jax.jit(lambda: alloc_shard(spec))()
    rng = np.random.default_rng(0)
    n_live = int(rows * 0.8)

    import dataclasses as _dc

    spec_prefill = _dc.replace(spec, insert_cap=None)

    @partial(jax.jit, donate_argnums=(0,))
    def prefill(shard, hi, lo):
        valid = hashing.is_valid(hi, lo)
        shard, _, _ = xla_ops.find_or_insert(
            spec_prefill, shard, hi, lo, valid, jnp.int32(0)
        )
        return shard

    pf = min(batch, 1 << 20)
    for i in range(0, n_live, pf):
        mult = np.int64(0x9E3779B97F4A7C15 & 0x7FFFFFFFFFFFFFFF)
        ids = (np.arange(i, i + pf, dtype=np.int64) % n_live) * mult
        hi, lo = hashing.split_ids(ids)
        shard = prefill(shard, jnp.asarray(hi), jnp.asarray(lo))
    jax.block_until_ready(shard.values)

    # the same fused window-space hot path bench.py measures (VERDICT r1
    # weak-#7: the CLI previously used the slower non-fused path)
    ucap = max(1024, batch // 2)  # ~35% unique under the zipf stream

    @partial(jax.jit, donate_argnums=(0,))
    def lookup_cycle(shard, hi, lo):
        uniq = dedup.unique_pairs(hi, lo, ucap)
        if spec.dim <= 128:
            shard, ctx = xla_ops.lookup_train(
                spec, shard, uniq.hi, uniq.lo, uniq.valid, jnp.int32(1)
            )
            out = xla_ops.rows_for_batch(spec, ctx.g128, ctx.sub, uniq.inverse)
        else:
            shard, slot, _ = xla_ops.find_or_insert(
                spec, shard, uniq.hi, uniq.lo, uniq.valid, jnp.int32(1)
            )
            out = xla_ops.lookup_rows(spec, shard, slot)[uniq.inverse]
        return shard, jnp.sum(out)

    @partial(jax.jit, donate_argnums=(0,))
    def update_cycle(shard, hi, lo):
        uniq = dedup.unique_pairs(hi, lo, ucap)
        if spec.dim <= 128:
            shard, ctx = xla_ops.lookup_train(
                spec, shard, uniq.hi, uniq.lo, uniq.valid, jnp.int32(1)
            )
            out = xla_ops.rows_for_batch(spec, ctx.g128, ctx.sub, uniq.inverse)
            g_u = xla_ops.grads_to_window(
                spec, out * 1e-3, ctx.sub, uniq.inverse, ucap
            )
            shard = optim.apply_sparse_grads_ctx(spec, shard, ctx, g_u)
        else:
            shard, slot, _ = xla_ops.find_or_insert(
                spec, shard, uniq.hi, uniq.lo, uniq.valid, jnp.int32(1)
            )
            out = xla_ops.lookup_rows(spec, shard, slot)[uniq.inverse]
            g = dedup.segment_sum_grads(out * 1e-3, uniq.inverse, ucap)
            shard = optim.apply_sparse_grads(spec, shard, slot, g)
        return shard, jnp.sum(out)

    fn = update_cycle if update else lookup_cycle
    batches = []
    mult = np.int64(0x9E3779B97F4A7C15 & 0x7FFFFFFFFFFFFFFF)
    t = 1.0 - 1.05  # bounded Zipf(1.05), like bench.py's stream
    for _ in range(args.steps):
        u = rng.random(batch)
        k = ((float(n_live) ** t - 1.0) * u + 1.0) ** (1.0 / t)
        ids = (np.minimum(k.astype(np.int64), n_live) - 1) * mult
        hi, lo = hashing.split_ids(ids)
        batches.append((jnp.asarray(hi), jnp.asarray(lo)))
    shard, s = fn(shard, *batches[0])  # compile
    jax.block_until_ready(s)
    windows = []
    for _w in range(3):  # best-of-3: the first window carries warm-up noise
        t0 = time.perf_counter()
        accs = []
        for i, (h, l) in enumerate(batches):
            shard, s = fn(shard, h, l)
            accs.append(s)
            if i >= 2:  # at most two steps in flight
                jax.block_until_ready(accs[i - 2])
        jax.block_until_ready((shard, accs[-1]))
        windows.append((time.perf_counter() - t0) / args.steps)
    dt = min(windows)
    name = "update" if update else "lookup"
    print(json.dumps({
        "device": describe(dev),
        "metric": f"{name}_ids_per_sec_per_chip",
        "value": round(batch / dt, 1),
        "unit": "ids/s",
        "rows": rows,
        "ms_per_step": round(dt * 1e3, 3),
    }))
    return 0


def cmd_bench_lookup(args) -> int:
    return _bench_table(args, update=False)


def cmd_bench_update(args) -> int:
    return _bench_table(args, update=True)


def _serve_latency_line(lat_ms, batch_size) -> None:
    """End-of-run per-batch latency stats on stderr (stdout stays one JSON
    prediction line per batch — the stable contract)."""
    if not lat_ms:
        return
    a = np.asarray(lat_ms[1:] or lat_ms)  # drop compile batch
    print(json.dumps({
        "serve_latency_ms": {
            "p50": round(float(np.percentile(a, 50)), 2),
            "p95": round(float(np.percentile(a, 95)), 2),
            "p99": round(float(np.percentile(a, 99)), 2),
            "mean": round(float(a.mean()), 2),
        },
        "batch_size": batch_size,
        "batches": len(lat_ms),
    }), file=sys.stderr)


def _serve_group(args, run_cfg, tables, feature_map, model_cfg) -> int:
    """Batch scoring from a heterogeneous `tables:` group checkpoint:
    restore every member (+ the dense tower) and stream batches through the
    group eval step (probe-only lookups — serving semantics: unknown ids
    score with zero embeddings). --distributed restores the members
    row-sharded over the local mesh and scores via the per-table a2a."""
    import jax

    if getattr(args, "http", 0):
        # online endpoint over the group checkpoint (GroupScoringService):
        # same HTTP surface as the single-table services; --distributed
        # restores every member row-sharded over the local mesh
        from meepoembedding_tpu.serving import make_http_server
        from meepoembedding_tpu.serving_group import GroupScoringService

        svc = GroupScoringService(
            args.ckpt, run_cfg, tables, feature_map, model_cfg,
            distributed=bool(getattr(args, "distributed", False)
                             and jax.device_count() > 1),
        )
        srv = make_http_server(svc, args.http)
        print(json.dumps({"serving": f"http://127.0.0.1:{args.http}",
                          **svc.stats()}), flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0
    stream = make_train_stream(
        args.data, run_cfg, model_cfg, jax.process_index(),
        jax.process_count(), bag_len=getattr(args, "bag_len", 1),
    )
    if getattr(args, "distributed", False) and jax.device_count() > 1:
        from meepoembedding_tpu.group_train import ShardedGroupTrainer

        tr = ShardedGroupTrainer(run_cfg, tables, feature_map, model_cfg)
    else:
        from meepoembedding_tpu.group_train import GroupTrainer

        tr = GroupTrainer(run_cfg, tables, feature_map, model_cfg)
    tr.load_checkpoint(args.ckpt)
    lat_ms = []
    for i, batch in enumerate(stream.batches(run_cfg.steps)):
        t0 = time.perf_counter()
        out = tr.eval_step(batch)
        logits = out["logits"]
        if hasattr(logits, "addressable_shards"):
            logits = np.concatenate([
                np.asarray(s.data) for s in sorted(
                    logits.addressable_shards,
                    key=lambda s: s.index[0].start or 0,
                )
            ])
        p = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64)))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({
            "batch": i,
            "mean_score": float(np.mean(p)),
            "scores": p[: args.emit].round(6).tolist(),
        }))
    _serve_latency_line(lat_ms, run_cfg.batch_size)
    return 0


def cmd_serve(args) -> int:
    """Batch scoring from a checkpoint (the serving half of README.md:2's
    'recommendation, search, CTR and advertising systems'): restore the
    table + tower, stream batches, emit one JSON line of predictions per
    batch plus end-of-run latency stats (p50/p95/p99 per batch). Lookups
    are train=False (no insert-on-miss; unknown ids score with zero
    embeddings). --distributed restores the table row-sharded over ALL
    local devices and serves through the all-to-all exchange path. A
    `tables:` group config serves the heterogeneous group checkpoint."""
    import jax
    import jax.numpy as jnp

    grp = load_group_configs(args.config, args.set)
    if grp is not None:  # heterogeneous multi-table checkpoint (group.json)
        return _serve_group(args, *grp)
    run_cfg, table_cfg, model_cfg = load_configs(args.config, args.set)
    model_cfg = dataclasses.replace(model_cfg, embedding_dim=table_cfg.dim)
    if getattr(args, "http", 0):
        # online endpoint: block serving HTTP until interrupted
        from meepoembedding_tpu.serving import ScoringService, make_http_server

        if getattr(args, "distributed", False):
            # row-sharded serving over every local device: the checkpoint
            # elastic-restores onto the mesh and /score rides the probe-only
            # a2a exchange (serving_sharded.ShardedScoringService). Same
            # HTTP surface — score/reload/healthz/metrics — as single-device.
            if getattr(args, "quantize", "none") != "none":
                raise SystemExit(
                    "serve --http --distributed serves full-precision rows; "
                    "drop --quantize (int8 is single-device only)"
                )
            from meepoembedding_tpu.serving_sharded import ShardedScoringService

            svc = ShardedScoringService(args.ckpt, table_cfg, model_cfg)
        else:
            svc = ScoringService(args.ckpt, table_cfg, model_cfg,
                                 quantize=getattr(args, "quantize", "none"))
        retrieval = None
        if getattr(args, "retrieval_items", None):
            # two-tower retrieval endpoint: corpus npz with item_ids [N, IF]
            # (+ optional keys [N]) embedded through the item tower once
            from meepoembedding_tpu.retrieval import RetrievalService

            corpus = np.load(args.retrieval_items)
            retrieval = RetrievalService(svc)
            keys = corpus["keys"] if "keys" in corpus.files else None
            retrieval.build_index(corpus["item_ids"], keys=keys)
            print(json.dumps({"retrieval_index": retrieval.index.num_items}),
                  flush=True)
        srv = make_http_server(svc, args.http, retrieval=retrieval)
        print(json.dumps({"serving": f"http://127.0.0.1:{args.http}",
                          **svc.stats()}), flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0
    from meepoembedding_tpu import checkpoint
    from meepoembedding_tpu.models import build_model

    if args.data == "synthetic":
        from meepoembedding_tpu.data.synthetic import SyntheticConfig, SyntheticStream

        stream = SyntheticStream(SyntheticConfig(
            batch_size=run_cfg.batch_size,
            num_sparse=model_cfg.num_sparse_features,
            num_dense=model_cfg.num_dense_features,
            seed=run_cfg.seed,
            bag_len=getattr(args, "bag_len", 1),
        ))
    else:
        from meepoembedding_tpu.data.criteo import CriteoStream

        stream = CriteoStream(_expand_paths(args.data), batch_size=run_cfg.batch_size)

    lat_ms = []
    if getattr(args, "distributed", False) and jax.device_count() > 1:
        # sharded serving: elastic-restore onto the local mesh, score via the
        # eval exchange (probe-only lookups, rows ride the a2a back)
        from meepoembedding_tpu.parallel.trainer import ShardedTrainer

        tr = ShardedTrainer(run_cfg, table_cfg, model_cfg)
        tr.load_checkpoint(args.ckpt)
        for i, batch in enumerate(stream.batches(run_cfg.steps)):
            t0 = time.perf_counter()
            out = tr.eval_step(batch)
            p = jax.nn.sigmoid(np.concatenate([
                np.asarray(s.data) for s in sorted(
                    out["logits"].addressable_shards,
                    key=lambda s: s.index[0].start or 0,
                )
            ]))
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps({
                "batch": i,
                "mean_score": float(np.mean(p)),
                "scores": np.asarray(p[: args.emit]).round(6).tolist(),
            }))
    else:
        from meepoembedding_tpu.table.runtime import DynamicEmbeddingTable

        table = DynamicEmbeddingTable(table_cfg)
        manifest = table.load(args.ckpt)
        model = build_model(model_cfg)
        params = model.init(jax.random.PRNGKey(0))
        if "params" in manifest.get("dense", []):
            params = checkpoint.load_dense(args.ckpt, "params", params)

        from meepoembedding_tpu.models.common import model_apply, model_inputs
        from meepoembedding_tpu.table import hashing as _hashing

        @jax.jit
        def score(shard, params, dense, rows, hi, lo):
            bag_valid = _hashing.is_valid(hi, lo) if hi.ndim == 3 else None
            emb = model_inputs(
                model, rows, hi, bag_valid, table_cfg.dim, model_cfg.combiner
            )
            return jax.nn.sigmoid(model_apply(model, params, dense, emb, bag_valid))

        for i, batch in enumerate(stream.batches(run_cfg.steps)):
            t0 = time.perf_counter()
            rows = table.lookup(batch["ids"].reshape(-1), train=False)
            hi_b, lo_b = _hashing.split_ids(batch["ids"])
            p = score(table.shard, params, jnp.asarray(batch["dense"]), rows,
                      jnp.asarray(hi_b), jnp.asarray(lo_b))
            p = np.asarray(p)  # host fetch = real completion barrier
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps({
                "batch": i,
                "mean_score": float(np.mean(p)),
                "scores": p[: args.emit].round(6).tolist(),
            }))
    _serve_latency_line(lat_ms, run_cfg.batch_size)
    return 0


def cmd_eval(args) -> int:
    """Offline evaluation from a checkpoint: restore table + tower, stream a
    labeled dataset with probe-only lookups (no insert-on-miss — unknown ids
    score with zero embeddings, exactly the serving semantics), and report
    AUC + mean loss as one JSON line. The holdout half of SURVEY.md C16's
    'AUC eval'; `serve` is the unlabeled scoring variant."""
    import jax

    run_cfg, table_cfg, model_cfg = load_configs(args.config, args.set)
    model_cfg = dataclasses.replace(model_cfg, embedding_dim=table_cfg.dim)
    grp = load_group_configs(args.config, args.set)
    if grp is not None:  # heterogeneous multi-table checkpoint (group.json)
        run_cfg, _, _, model_cfg = grp
    if args.data == "synthetic":
        stream = make_train_stream(
            args.data, run_cfg, model_cfg, jax.process_index(),
            jax.process_count(), bag_len=getattr(args, "bag_len", 1),
        )
        batches = stream.batches(run_cfg.steps)
    else:
        # offline eval makes exactly ONE pass over the holdout (loop=False);
        # run.steps does not truncate it. Host-sharded like training.
        from meepoembedding_tpu.data.criteo import CriteoStream

        stream = CriteoStream(
            _expand_paths(args.data), batch_size=run_cfg.batch_size,
            loop=False, host_id=jax.process_index(),
            num_hosts=jax.process_count(),
        )
        batches = stream.batches(None)
    if getattr(args, "retrieval_items", None):
        # two-tower retrieval eval: recall@k over an embedded item corpus
        from meepoembedding_tpu.retrieval import RetrievalService
        from meepoembedding_tpu.serving import ScoringService

        svc = ScoringService(args.ckpt, table_cfg, model_cfg)
        ret = RetrievalService(svc)
        corpus = np.load(args.retrieval_items)
        keys = corpus["keys"] if "keys" in corpus.files else None
        ret.build_index(corpus["item_ids"], keys=keys)
        ks = [int(k) for k in str(args.topk).split(",")]
        print(json.dumps(ret.evaluate(batches, ks=ks)))
        return 0
    if grp is not None:
        # heterogeneous multi-table checkpoint (group.json layout)
        if getattr(args, "distributed", False) and jax.device_count() > 1:
            from meepoembedding_tpu.group_train import ShardedGroupTrainer

            tr = ShardedGroupTrainer(*grp)
        else:
            from meepoembedding_tpu.group_train import GroupTrainer

            tr = GroupTrainer(*grp)
    elif getattr(args, "distributed", False) and jax.device_count() > 1:
        from meepoembedding_tpu.parallel.trainer import ShardedTrainer

        tr = ShardedTrainer(run_cfg, table_cfg, model_cfg)
    else:
        from meepoembedding_tpu.train import Trainer

        tr = Trainer(run_cfg, table_cfg, model_cfg)
    tr.load_checkpoint(args.ckpt)
    from meepoembedding_tpu.metrics import StreamingAUC

    auc = StreamingAUC()
    losses = []
    n = 0
    for batch in batches:
        out = tr.eval_step(batch)
        logits = out["logits"]
        if hasattr(logits, "addressable_shards"):
            logits = np.concatenate([
                np.asarray(s.data) for s in sorted(
                    logits.addressable_shards, key=lambda s: s.index[0].start or 0
                )
            ])
        auc.update(np.asarray(logits), np.asarray(batch["label"]))
        losses.append(float(out["loss"]))
        n += len(np.asarray(batch["label"]))
    out = {
        "auc": float(auc.compute()),
        "mean_loss": float(np.mean(losses)) if losses else None,
        "examples": n,
        "batches": len(losses),
    }
    # sharded eval: exchange-capacity overflows silently scored zero rows;
    # surface the count so the reading is never trusted blind (VERDICT r2 #5)
    if hasattr(tr, "eval_route_drops"):
        out["eval_route_drops"] = int(tr.eval_route_drops)
    print(json.dumps(out))
    return 0


def cmd_ckpt_export(args) -> int:
    """Export a checkpoint's embedding rows to a portable format for
    downstream systems (the migration path OUT of the framework, mirroring
    the KV tiers' import path in): streamed shard-by-shard, bounded memory.

      npz   one .npz with ids [N] int64 + values [N, dim] f32
            (+ freq/accum when --full)
      tsv   one line per row: id \\t v0,v1,...  (text, diffable)
    """
    from meepoembedding_tpu import checkpoint

    m = checkpoint.read_manifest(args.path)
    rows_total = 0
    if args.format == "npz":
        ids_parts, val_parts, extra = [], [], {}
        for data in checkpoint.iter_rows(args.path):
            ids_parts.append(data["ids"])
            val_parts.append(data["values"])
            if args.full:
                for k in ("freq", "accum"):
                    if k in data:
                        extra.setdefault(k, []).append(data[k])
            rows_total += len(data["ids"])
        out = {
            "ids": np.concatenate(ids_parts) if ids_parts else np.zeros(0, np.int64),
            "values": np.concatenate(val_parts) if val_parts else np.zeros((0, m["dim"])),
        }
        for k, v in extra.items():
            out[k] = np.concatenate(v)
        np.savez_compressed(args.out, **out)
    else:  # tsv
        with open(args.out, "w") as fh:
            for data in checkpoint.iter_rows(args.path):
                for i in range(len(data["ids"])):
                    vals = ",".join(repr(float(x)) for x in data["values"][i])
                    fh.write(f"{int(data['ids'][i])}\t{vals}\n")
                rows_total += len(data["ids"])
    print(json.dumps({"rows": rows_total, "out": args.out, "format": args.format,
                      "dim": m["dim"], "step": m["step"]}))
    return 0


def cmd_ckpt_import(args) -> int:
    """Warm-start a table from a portable row dump — the reverse of
    `ckpt-export` and the migration path INTO the framework (e.g. seeding a
    dynamic table from a static fixed-vocab embedding matrix or another
    system's export). Reads ids+values from .npz (ids [N] int64,
    values [N, dim]) or .tsv (id \\t v0,v1,...), bulk-assigns them into a
    fresh table, and writes a normal elastic checkpoint that
    `train --restore` / `serve` / `eval` all accept.

    Optimizer state starts fresh: a portable dump is values-only by contract
    (freq/accum from `ckpt-export --full` describe THIS framework's policy
    state; foreign dumps won't have them), so imported rows behave like
    newly admitted ids with pre-trained values.
    """
    from meepoembedding_tpu.table import hashing
    from meepoembedding_tpu.table.runtime import DynamicEmbeddingTable

    src = args.src
    fmt = args.format or ("npz" if src.endswith(".npz") else "tsv")
    if fmt == "npz":
        with np.load(src) as z:
            ids = np.asarray(z["ids"], np.int64)
            values = np.asarray(z["values"], np.float32)
    else:
        id_list, row_list = [], []
        with open(src) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                key, _, vals = line.partition("\t")
                id_list.append(int(key))
                row_list.append([float(x) for x in vals.split(",")])
        ids = np.asarray(id_list, np.int64)
        values = np.asarray(row_list, np.float32) if row_list else np.zeros((0, 0))
    n, dim = (values.shape if values.ndim == 2 else (0, 0))
    assert len(ids) == n, f"ids [{len(ids)}] vs values [{n}] row mismatch"

    _, table_cfg, _ = load_configs(args.config, args.set)
    if n and table_cfg.dim != dim:  # the file is ground truth for dim
        table_cfg = dataclasses.replace(table_cfg, dim=dim)
    if args.capacity == "auto":
        cap = 1 << 10
        while n > 0.8 * cap:
            cap *= 2
        table_cfg = dataclasses.replace(table_cfg, capacity=max(cap, table_cfg.capacity))
    else:
        table_cfg = dataclasses.replace(table_cfg, capacity=int(float(args.capacity)))

    table = DynamicEmbeddingTable(table_cfg)
    chunk = 1 << 14
    imported = 0
    for o in range(0, n, chunk):
        sl = slice(o, min(n, o + chunk))
        cnt = sl.stop - sl.start
        pad = chunk - cnt
        ids_c = ids[sl]
        rows_c = values[sl]
        if pad:  # fixed chunk geometry -> one compiled assign program
            ids_c = np.concatenate([ids_c, np.full(pad, hashing.EMPTY_ID, np.int64)])
            rows_c = np.concatenate([rows_c, np.zeros((pad, dim), np.float32)])
        ok = table.assign(ids_c, rows_c)
        imported += int(np.asarray(ok)[:cnt].sum())
    manifest = table.save(args.out)
    print(json.dumps({
        "rows_in_file": int(n), "rows_imported": imported,
        "capacity": table_cfg.capacity, "dim": table_cfg.dim,
        "out": args.out, "step": manifest.get("step", 0),
    }))
    return 0 if imported == n else 4


def _inspect_table_ckpt(path: str) -> dict:
    from meepoembedding_tpu import checkpoint

    out = dict(checkpoint.read_manifest(path))
    rows = 0
    freq_sum = 0
    for data in checkpoint.iter_rows(path):
        rows += len(data["ids"])
        freq_sum += int(data["freq"].sum()) if len(data["ids"]) else 0
    out["total_rows"] = rows
    out["total_hits_recorded"] = freq_sum
    return out


def cmd_ckpt_inspect(args) -> int:
    group_path = os.path.join(args.path, "group.json")
    if os.path.exists(group_path):  # heterogeneous group checkpoint
        with open(group_path) as f:
            manifest = json.load(f)
        out = dict(manifest)
        out["tables"] = {
            n: _inspect_table_ckpt(os.path.join(args.path, sub))
            for n, sub in manifest["tables"].items()
        }
        out["total_rows"] = sum(t["total_rows"] for t in out["tables"].values())
        print(json.dumps(out, indent=1))
        return 0
    print(json.dumps(_inspect_table_ckpt(args.path), indent=1))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="meepoembedding_tpu",
        description="dynamic embedding framework in JAX (MeepoEmbedding class)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a CTR/DLRM model on a dynamic table")
    t.add_argument("--config", help="YAML config file")
    t.add_argument("--set", nargs="*", default=[], metavar="sec.key=val",
                   help="dotted overrides, e.g. table.capacity=1e6 run.steps=200")
    t.add_argument("--data", default="synthetic",
                   help="'synthetic' or comma-separated Criteo TSV paths")
    t.add_argument("--bag-len", type=int, default=1,
                   help="synthetic multi-hot bag length L (>1 -> [B,S,L] ids "
                        "pooled by model.combiner; see ops/pooling.py)")
    t.add_argument("--distributed", action="store_true",
                   help="row-shard the table over all local devices")
    t.add_argument("--spill", choices=["none", "host", "python", "disk", "redis"],
                   default="none", help="cold-tier backend for evicted rows")
    t.add_argument("--spill-path", help="disk spill log path")
    t.add_argument("--spill-addr", help="redis host:port")
    t.add_argument("--maintenance-every", type=int, default=50)
    t.add_argument("--ckpt-dir", help="save an elastic checkpoint here at the end")
    t.add_argument("--ckpt-every", type=int, default=0)
    t.add_argument("--restore", help="restore from this checkpoint before training")
    t.add_argument("--col-shards", type=int, default=1,
                   help="column (dim) shards for 2-D row x dim table "
                        "parallelism (requires --distributed; dim %% N == 0)")
    t.set_defaults(fn=cmd_train)

    for name, fn in (("bench-lookup", cmd_bench_lookup), ("bench-update", cmd_bench_update)):
        b = sub.add_parser(name, help=f"{name} throughput on one chip")
        b.add_argument("--rows", default="1e6", help="table capacity (prefilled to 80%%)")
        b.add_argument("--batch", default="65536")
        b.add_argument("--dim", type=int, default=32)
        b.add_argument("--steps", type=int, default=20)
        b.set_defaults(fn=fn)

    sv = sub.add_parser("serve", help="batch scoring from a checkpoint (no inserts)")
    sv.add_argument("--ckpt", required=True, help="checkpoint directory to restore")
    sv.add_argument("--config", help="YAML config file")
    sv.add_argument("--set", nargs="*", default=[], metavar="sec.key=val")
    sv.add_argument("--data", default="synthetic",
                    help="'synthetic' or comma-separated Criteo TSV paths")
    sv.add_argument("--emit", type=int, default=8,
                    help="scores per batch to include in the JSON output")
    sv.add_argument("--bag-len", type=int, default=1,
                    help="synthetic multi-hot bag length L")
    sv.add_argument("--quantize", choices=["none", "int8"], default="none",
                    help="serve from an int8-quantized read-only table "
                         "(~3x smaller; --http mode)")
    sv.add_argument("--retrieval-items", default=None, metavar="NPZ",
                    help="two_tower only: .npz with item_ids [N, IF] int64 "
                         "(+ optional keys [N]); enables POST /retrieve "
                         "top-k over the embedded corpus (--http mode)")
    sv.add_argument("--http", type=int, default=0, metavar="PORT",
                    help="serve an HTTP scoring endpoint on 127.0.0.1:PORT "
                         "(POST /score, GET /healthz) instead of batch mode")
    sv.add_argument("--distributed", action="store_true",
                    help="row-shard the restored table over all local devices")
    sv.set_defaults(fn=cmd_serve)

    ev = sub.add_parser("eval", help="offline AUC/loss eval from a checkpoint")
    ev.add_argument("--config", help="YAML config file")
    ev.add_argument("--set", nargs="*", default=[], metavar="sec.key=val")
    ev.add_argument("--ckpt", required=True, help="checkpoint directory")
    ev.add_argument("--data", default="synthetic",
                    help="'synthetic' or comma-separated Criteo TSV paths")
    ev.add_argument("--bag-len", type=int, default=1,
                    help="synthetic multi-hot bag length L")
    ev.add_argument("--distributed", action="store_true",
                    help="restore row-sharded over all local devices")
    ev.add_argument("--retrieval-items", default=None, metavar="NPZ",
                    help="two_tower only: item corpus (item_ids [N, IF] "
                         "int64 + optional keys [N]); reports recall@k "
                         "instead of AUC")
    ev.add_argument("--topk", default="1,10,100",
                    help="comma-separated k values for recall@k")
    ev.set_defaults(fn=cmd_eval)

    ce = sub.add_parser("ckpt-export", help="export rows to npz/tsv")
    ce.add_argument("path", help="checkpoint directory")
    ce.add_argument("--out", required=True, help="output file")
    ce.add_argument("--format", choices=["npz", "tsv"], default="npz")
    ce.add_argument("--full", action="store_true",
                    help="include freq/accum state (npz only)")
    ce.set_defaults(fn=cmd_ckpt_export)

    ci = sub.add_parser("ckpt-import",
                        help="warm-start a checkpoint from an npz/tsv row dump")
    ci.add_argument("src", help="input file (.npz: ids+values; or tsv)")
    ci.add_argument("--out", required=True, help="checkpoint directory to write")
    ci.add_argument("--format", choices=["npz", "tsv"], default=None,
                    help="default: by file extension")
    ci.add_argument("--config", help="YAML config file (table.* honored)")
    ci.add_argument("--set", nargs="*", default=[], metavar="sec.key=val")
    ci.add_argument("--capacity", default="auto",
                    help="'auto' (pow2, load<=0.8) or an explicit row count")
    ci.set_defaults(fn=cmd_ckpt_import)

    c = sub.add_parser("ckpt-inspect", help="print checkpoint manifest + stats")
    c.add_argument("path")
    c.set_defaults(fn=cmd_ckpt_inspect)

    args = p.parse_args(argv)
    from meepoembedding_tpu.device import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
