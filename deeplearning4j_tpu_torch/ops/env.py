"""Env knobs the port reads — its own copy of the entries of the JAX
package's table (``deeplearning4j_tpu/ops/env.py``) that the ported paths
read, same names, kinds and defaults: the ``/generate`` decode planes
(paged and fixed-slot pools, k-step ticks, speculative decode, the KV
arena's dtype), the ``/predict`` batcher, shape bucketing, the remat
policy (``ops/remat.py``) and bf16 loss-scaled training
(``ops/lowprec.py``), and the serving planes: calibrated int8
``/predict``, the circuit breaker, the watchdog, drain, SLO classes and
tenant quotas; ``/embed``'s layer and pooling (``retrieval/embed.py``);
``/search``'s arena rows, IVF clusters and probes (``retrieval/``); the
observability plane (``obs/``: the span gate, the span ring, the
journal's path, ring and flush interval, the exporter's port, and the
process id that suffixes the journal's default path); the online feed
(``online/``: the stream's watermark and idle window, the drift bar);
the dataset directory (``datasets/fetchers.py``); and the training
runtime: the input pipeline's workers and prefetch depth
(``etl/pipeline.py``, ``datasets/iterator.AsyncDataSetIterator``), the
checkpoint cadence, retention and async switch
(``resilience/checkpoint.py``), and the process count that, with the
process id, shards a pipeline and picks the process that writes
checkpoints.
The rest of the table waits for the slices that read them.

A read of a name that is not in this table raises, so a typo fails
loudly instead of silently meaning "default" (the JAX table's rule).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional


class KnobError(KeyError):
    """Read of a knob name that is not in this table."""


@dataclass(frozen=True)
class Knob:
    name: str
    default: str  # raw default, as the env string
    kind: str     # int | float | bool | enum | str | path
    doc: str


KNOBS: Dict[str, Knob] = {}


def _register(name: str, default: str, kind: str, doc: str) -> None:
    KNOBS[name] = Knob(name, default, kind, doc)


_register("DL4J_TPU_BUCKET_BATCHES", "", "enum",
          "shape bucketing for ragged batches: '' auto (fit_iterator/"
          "output only), 1 every fit, 0 off")
_register("DL4J_TPU_REMAT", "", "enum",
          "activation-remat policy ladder for block scans and per-layer "
          "remat: none (default) / dots / block")
_register("DL4J_TPU_BF16", "0", "bool",
          "bf16 master-weight training mode for the containers and "
          "TransformerLM/BertMLM: f32 master params + updater state, bf16 "
          "cast at the train-step boundary, dynamic loss scaling "
          "(halve-and-skip on non-finite grads)")
_register("DL4J_TPU_LOSS_SCALE", "", "str",
          "dynamic loss-scale policy 'init' or 'init:growth_interval' "
          "('' = 32768:2000: start at 2^15, double after 2000 clean "
          "steps, halve-and-skip on non-finite grads, floor 1)")
_register("DL4J_TPU_SERVE_MAX_BATCH", "64", "int",
          "dynamic-batcher max rows per dispatched batch")
_register("DL4J_TPU_SERVE_MAX_WAIT_MS", "10", "float",
          "dynamic-batcher admission window (ms)")
_register("DL4J_TPU_SERVE_BATCH", "", "bool",
          "0 = naive locked per-request /predict instead of dynamic "
          "batching")
_register("DL4J_TPU_SERVE_QUEUE_CAP", "512", "int",
          "request queue cap; past it /generate and /predict answer 429")
_register("DL4J_TPU_SERVE_TIMEOUT_S", "60", "float",
          "per-request deadline; past it /generate and /predict answer 504")
_register("DL4J_TPU_SERVE_SLOTS", "4", "int",
          "slots of the fixed-slot pool; lane floor of the paged pool")
_register("DL4J_TPU_SERVE_KV_BLOCK", "16", "int",
          "paged-KV block size in tokens for /generate (0 = the "
          "fixed-slot pool)")
_register("DL4J_TPU_SERVE_KV_BLOCKS", "0", "int",
          "paged-KV arena size in blocks (0 = auto-size from the "
          "device's memory via ops/memory.kv_arena_blocks)")
_register("DL4J_TPU_SERVE_KV_DTYPE", "", "enum",
          "paged-KV arena dtype: '' = the model's compute dtype, bf16 "
          "halves KV bytes (the same budget admits ~2x tokens), f32 "
          "forces full precision")
_register("DL4J_TPU_SERVE_TICK_K", "1", "int",
          "decode steps per tick for the fixed-slot and paged /generate "
          "pools; the worker drops to 1 whenever admissions are pending "
          "or a lane is within k tokens of its budget")
_register("DL4J_TPU_SERVE_SPEC", "", "str",
          "self-speculative decoding draft for greedy /generate on the "
          "paged pool: '' off, int8 = weight-quantized self-draft, "
          "layers[:m] = truncated-layer self-draft")
_register("DL4J_TPU_SERVE_SPEC_K", "4", "int",
          "draft tokens proposed per speculative round (the target "
          "verifies k+1 positions)")
_register("DL4J_TPU_QUANT", "", "enum",
          "calibrated int8 serving: '' auto (quantize when the model zip "
          "carries quant.json AND the accuracy gate passes), 0 off, force "
          "(quantize even when the gate delta exceeds the bar; the delta "
          "is still measured and reported)")
_register("DL4J_TPU_QUANT_MAX_DELTA", "0.05", "float",
          "int8 accuracy gate: max abs output delta vs the f32 record "
          "measured at registry load on the calibration gate sample; past "
          "it the record lands broken and the serving default never moves")
_register("DL4J_TPU_SERVE_CONTINUOUS", "", "bool",
          "0 = disable continuous-batching decode for /generate")
_register("DL4J_TPU_SERVE_BREAKER_FAILS", "5", "int",
          "consecutive inference failures that open a model's circuit "
          "breaker (0 disables)")
_register("DL4J_TPU_SERVE_WATCHDOG_S", "30", "float",
          "hung-inference watchdog wall deadline per dispatch (0 "
          "disables)")
_register("DL4J_TPU_SERVE_DRAIN_S", "20", "float",
          "graceful-drain deadline on stop()/SIGTERM")
_register("DL4J_TPU_SERVE_SLO_CLASSES", "", "str",
          "SLO scheduling classes 'name:deadline_s,...' highest "
          "priority first ('' = one default class at the request "
          "timeout)")
_register("DL4J_TPU_SERVE_TENANT_QUOTAS", "", "str",
          "per-tenant token-bucket quotas 'name:rate_per_s[:burst],...'"
          " ('' = no tenant metering; unlisted tenants are unmetered)")
_register("DL4J_TPU_EMBED_LAYER", "", "int",
          "feed-forward embedding layer: int index into the MLN "
          "activations list ('' = -2, the last hidden layer); CG vertex "
          "selection is per-adapter, not env-driven")
_register("DL4J_TPU_EMBED_POOL", "mean", "str",
          "sequence pooling for BertMLM /embed contextual embeddings "
          "(mean | cls | max)")
_register("DL4J_TPU_ANN_ROWS", "0", "int",
          "vector-index arena capacity in rows (0 = auto-size from the "
          "device's memory via ops/memory.ann_arena_rows)")
_register("DL4J_TPU_ANN_CLUSTERS", "0", "int",
          "IVF coarse-quantizer cluster count (0 = auto ~= sqrt(rows))")
_register("DL4J_TPU_ANN_NPROBE", "8", "int",
          "IVF clusters probed per /search query (recall/qps dial; "
          "measured recall@k vs the exact oracle rides "
          "retrieval_stats.last_recall)")
_register("DL4J_TPU_OBS", "0", "bool",
          "span tracer master switch (default OFF; obs off => training "
          "bit-exact)")
_register("DL4J_TPU_OBS_SPANS", "4096", "int",
          "span ring capacity per tracer")
_register("DL4J_TPU_OBS_JOURNAL", "", "path",
          "flight-recorder JSONL path; '' = .obs_journal[.pN].jsonl under "
          "cwd (N = DL4J_TPU_PROCESS_ID)")
_register("DL4J_TPU_OBS_JOURNAL_N", "4096", "int",
          "flight-recorder event-ring cap")
_register("DL4J_TPU_OBS_FLUSH_S", "5", "float",
          "flight-recorder periodic flush interval (seconds)")
_register("DL4J_TPU_OBS_PORT", "0", "int",
          "standalone MetricsExporter HTTP port (0 = ephemeral)")
_register("DL4J_TPU_PROCESS_ID", "", "int",
          "this process's rank among cooperating processes; suffixes the "
          "default obs journal path")
_register("DL4J_TPU_ONLINE_WATERMARK", "64", "int",
          "StreamSource backpressure high watermark: push() blocks while "
          "this many batches sit undelivered")
_register("DL4J_TPU_ONLINE_IDLE_S", "0.2", "float",
          "idle window (seconds with no arrival) that ends a StreamSource "
          "poll pass (0 = block until close)")
_register("DL4J_TPU_ONLINE_DRIFT_Z", "3.0", "float",
          "DriftMonitor alarm threshold: max per-column "
          "|live_mean - base_mean| / base_std")
_register("DL4J_TPU_ONLINE_DRIFT_MIN", "64", "int",
          "minimum live rows before DriftMonitor.check() renders a "
          "verdict")
_register("DL4J_TPU_DATA_DIR", "", "path",
          "dataset cache dir; '' = ~/.deeplearning4j_tpu")
_register("DL4J_TPU_CKPT_EVERY", "0", "int",
          "checkpoint every N steps (0 = off)")
_register("DL4J_TPU_CKPT_KEEP", "3", "int",
          "keep-last-k checkpoints")
_register("DL4J_TPU_CKPT_ASYNC", "1", "bool",
          "0 = synchronous checkpoint writes")
_register("DL4J_TPU_PIPELINE_WORKERS", "0", "int",
          "InputPipeline worker threads (0 = off; >0 also opts "
          "fit_iterator into auto-wrapping plain iterators)")
_register("DL4J_TPU_PREFETCH", "2", "int",
          "staged-batch queue depth (shared with AsyncDataSetIterator)")
_register("DL4J_TPU_NUM_PROCESSES", "", "int",
          "jax.distributed process count")


def knob(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KnobError(f"{name} is not a knob of the port's table "
                        "(deeplearning4j_tpu_torch/ops/env.py)") from None


def raw(name: str) -> str:
    """The env string, or the table default when unset or empty."""
    k = knob(name)
    v = os.environ.get(name)
    return k.default if v is None or v == "" else v


def get_int(name: str) -> int:
    """Integer value; garbage falls back to the table default."""
    try:
        return int(raw(name).strip())
    except ValueError:
        return int(knob(name).default)


def get_int_or(name: str, default: int) -> int:
    """Integer value when the knob is set, ``default`` when it is unset,
    empty or garbage (the JAX table's ``get_int(name, default)``)."""
    v = os.environ.get(name)
    knob(name)
    try:
        return int(v.strip()) if v else default
    except ValueError:
        return default


def get_opt_int(name: str) -> Optional[int]:
    """Integer value of a knob whose table default is empty (the process
    id and count): None when unset, empty or garbage."""
    try:
        return int(raw(name).strip())
    except ValueError:
        return None


def get_float(name: str) -> float:
    """Float value; garbage falls back to the table default."""
    try:
        return float(raw(name).strip())
    except ValueError:
        return float(knob(name).default)


_FALSY = ("0", "off", "false", "no")


def get_bool(name: str) -> bool:
    """The JAX table's bool convention: '0'/'off'/'false'/'no' => False,
    any other non-empty value => True, unset or empty => the table
    default (False when that is empty)."""
    v = raw(name).strip().lower()
    if v == "":
        v = knob(name).default.strip().lower()
    return v != "" and v not in _FALSY
