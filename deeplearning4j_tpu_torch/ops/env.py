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
checkpoints; the serving fleet (``serving/{router,fleet,autoscale,
placement,mesh}.py``: replicas, the router's port and replica breakers,
the autoscaler's bounds and votes, the per-card memory budget, the
serving mesh and the replica's role), the elastic fleet
(``parallel/fleet.py``: the spool directory, the heartbeat timeout and
the membership floor) and the online plane's shadow mirror, promotion
gate and snapshot cadence (``online/{promote,trainer}.py``).
The rest of the table waits for the slices that read them.

A read of a name that is not in this table raises, so a typo fails
loudly instead of silently meaning "default" (the JAX table's rule).
``knob_names``, ``is_registered`` and ``nonempty`` (JAX :371, :375 and
:434) answer for the port's table.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


class KnobError(KeyError):
    """Read of a knob name that is not in this table."""


@dataclass(frozen=True)
class Knob:
    name: str
    default: str  # raw default, as the env string
    kind: str     # int | float | bool | enum | str | path
    doc: str
    choices: Optional[Tuple[str, ...]] = None  # an enum's values


KNOBS: Dict[str, Knob] = {}


def _register(name: str, default: str, kind: str, doc: str,
              choices: Optional[Tuple[str, ...]] = None) -> None:
    KNOBS[name] = Knob(name, default, kind, doc, choices)


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
_register("DL4J_TPU_COORDINATOR", "", "str",
          "jax.distributed coordinator address (host:port); unset = "
          "single-process")
_register("DL4J_TPU_NUM_PROCESSES", "", "int",
          "jax.distributed process count")

# the serving fleet, the elastic fleet and the online plane
_register("DL4J_TPU_HBM_GB", "16", "float",
          "per-chip HBM budget (GB) the transformer preflight/auto-fit "
          "sizers fit against")
_register("DL4J_TPU_SERVE_MESH", "0", "int",
          "serving-mesh device count for the paged /generate plane: "
          ">= 2 runs the decode tick TP-style under shard_map over that "
          "many devices (attention heads + KV arena head-sharded, "
          "serving/mesh.MeshPagedDecoder — byte-identical to the "
          "single-device tick); 0/'' = single-device decoders")
_register("DL4J_TPU_SERVE_ROLE", "", "enum",
          "serving replica role for prefill/decode disaggregation: "
          "prefill = own long-prompt prefill and export primed KV "
          "blocks (/prefill), decode = own the latency-critical decode "
          "tick, '' = both; published in the replica-<id>.addr JSON so "
          "the FleetRouter routes /generate by role",
          choices=("", "prefill", "decode"))
_register("DL4J_TPU_SERVE_FLEET_REPLICAS", "2", "int",
          "serving-fleet replica count (ServingFleet default)")
_register("DL4J_TPU_SERVE_ROUTER_PORT", "0", "int",
          "FleetRouter HTTP port (0 = ephemeral)")
_register("DL4J_TPU_SERVE_REPLICA_FAILS", "3", "int",
          "consecutive connect/5xx failures that eject a replica from "
          "the router (0 disables replica breakers)")
_register("DL4J_TPU_SERVE_SCALE_MIN", "1", "int",
          "autoscaler floor: never scale the fleet below this many "
          "replicas")
_register("DL4J_TPU_SERVE_SCALE_MAX", "4", "int",
          "autoscaler ceiling: never scale the fleet above this many "
          "replicas")
_register("DL4J_TPU_SERVE_SCALE_UP_QUEUE", "8", "float",
          "scale-up pressure: mean queued requests per ready replica "
          "at or above this votes up for the tick")
_register("DL4J_TPU_SERVE_SCALE_UP_P99_FRAC", "0.8", "float",
          "scale-up pressure: a class p99 at or above this fraction of "
          "its SLO deadline votes up for the tick")
_register("DL4J_TPU_SERVE_SCALE_UP_SHED", "1", "int",
          "scale-up pressure: at least this many new router sheds "
          "since the previous tick votes up (0 disables the shed vote)")
_register("DL4J_TPU_SERVE_SCALE_WINDOW", "3", "int",
          "consecutive ticks of one-sided pressure before the "
          "autoscaler acts (the sustained-evidence window)")
_register("DL4J_TPU_SERVE_SCALE_DOWN_QUEUE", "0", "float",
          "scale-down pressure: mean queued requests per ready replica "
          "at or below this (with zero sheds) votes down for the tick")
_register("DL4J_TPU_SERVE_SCALE_COOLDOWN", "5", "int",
          "ticks after any scale action before the next one (counted "
          "in TICKS, not wall-clock, so decisions replay bit-exact)")
_register("DL4J_TPU_FLEET_HEARTBEAT_S", "5.0", "float",
          "elastic-fleet failure-detection heartbeat timeout (seconds)")
_register("DL4J_TPU_FLEET_MIN_WORKERS", "1", "int",
          "elastic-fleet round blocks below this live-membership size")
_register("DL4J_TPU_FLEET_DIR", "", "path",
          "default fleet spool/file-membership transport dir")
_register("DL4J_TPU_ONLINE_SNAPSHOT_ROUNDS", "1", "int",
          "candidate-snapshot cadence in fit rounds for "
          "ContinuousTrainer.export_candidate paths (0 = off)")
_register("DL4J_TPU_ONLINE_SHADOW_FRACTION", "1.0", "float",
          "fraction of answered /predict traffic mirrored to the shadow "
          "candidate (deterministic stride, not RNG)")
_register("DL4J_TPU_ONLINE_SHADOW_MIN", "32", "int",
          "minimum mirrored requests before ShadowPromoter.evaluate() "
          "will pass a candidate")
_register("DL4J_TPU_ONLINE_GATE_AGREE", "0.0", "float",
          "promotion gate: minimum shadow-vs-primary argmax agreement "
          "fraction (0 disables the agreement gate)")


def knob(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KnobError(f"{name} is not a knob of the port's table "
                        "(deeplearning4j_tpu_torch/ops/env.py)") from None


def knob_names() -> Tuple[str, ...]:
    """The port's table, sorted (JAX :371)."""
    return tuple(sorted(KNOBS))


def is_registered(name: str) -> bool:
    """Whether the port's table holds ``name`` (JAX :375)."""
    return name in KNOBS


def nonempty(name: str) -> bool:
    """``bool(os.environ.get(name))`` for a registered knob: any
    non-empty value, '0' included, is true (JAX :434)."""
    knob(name)
    return bool(os.environ.get(name))


def raw(name: str) -> str:
    """The env string, or the table default when unset or empty."""
    k = knob(name)
    v = os.environ.get(name)
    return k.default if v is None or v == "" else v


def get_int(name: str, default: Optional[int] = None) -> int:
    """Integer value; garbage falls back to the table default. With
    ``default``: that value when the knob is unset, empty or garbage
    (the JAX table's ``get_int(name, default)``)."""
    if default is not None:
        v = os.environ.get(name)
        knob(name)
        try:
            return int(v.strip()) if v else default
        except ValueError:
            return default
    try:
        return int(raw(name).strip())
    except ValueError:
        return int(knob(name).default)


def get_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """The env string, else ``default`` (the JAX table's ``get_str``:
    the table default only when no ``default`` is given)."""
    knob(name)
    v = os.environ.get(name)
    if v:
        return v
    if default is not None:
        return default
    return knob(name).default or None


def get_opt_int(name: str) -> Optional[int]:
    """Integer value of a knob whose table default is empty (the process
    id and count): None when unset, empty or garbage."""
    try:
        return int(raw(name).strip())
    except ValueError:
        return None


def get_float(name: str, default: Optional[float] = None) -> float:
    """Float value; garbage falls back to the table default (or to
    ``default``, which also stands for an unset knob when given)."""
    if default is not None:
        v = os.environ.get(name, "").strip()
        knob(name)
        try:
            return float(v) if v else default
        except ValueError:
            return default
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
