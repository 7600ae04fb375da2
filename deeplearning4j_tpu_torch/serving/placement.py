"""Memory-aware model placement: bin-pack models onto replicas
(counterpart: ``deeplearning4j_tpu/serving/placement.py`` —
``ModelFootprint``, ``model_footprint``, ``PlacementPlan`` and
``pack_models``).

Every model's resident device memory is priced by ``ops/memory`` (params,
the paged-KV arena its decoder would allocate, index arenas; closed
form) and first-fit-decreasing packed against each replica's budget:
``DL4J_TPU_HBM_GB`` GB per card, or the ``hbm_gb`` given. Everything
here is a pure function of its inputs — total-order sort keys, no RNG,
no clock — so a plan computed twice from the same footprints is
identical (the autoscaler's replay discipline). The plan is advice: the
router's affinity filter and ``/placement`` consume it; loading models
onto replicas stays with the registry lifecycle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence

from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops import memory


@dataclass(frozen=True)
class ModelFootprint:
    """One model's priced resident device memory: params (+ optimizer
    and state trees), the paged-KV arena a decoder would allocate for
    it, and any index arenas serving beside it. All three addends are
    closed-form shape arithmetic (``ops/memory``) — never a device
    read."""

    name: str
    param_bytes: int
    kv_bytes: int = 0
    ann_bytes: int = 0

    @property
    def total_bytes(self) -> int:
        return int(self.param_bytes) + int(self.kv_bytes) \
            + int(self.ann_bytes)

    def describe(self) -> Dict[str, int]:
        return {"param_bytes": int(self.param_bytes),
                "kv_bytes": int(self.kv_bytes),
                "ann_bytes": int(self.ann_bytes),
                "total_bytes": self.total_bytes}


def model_footprint(name: str, model, *, ann_bytes: int = 0,
                    hbm_gb: Optional[float] = None) -> ModelFootprint:
    """Price one loaded model. KV pricing mirrors what the serving
    engine would actually allocate: a paged block arena sized by
    ops/memory.kv_arena_blocks (plus the trash block) when the model is
    decode-eligible and ``DL4J_TPU_SERVE_KV_BLOCK`` > 0; the fixed
    pool's slots * max_len pre-allocation when the block knob is 0;
    zero for models with no generate surface."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    param_bytes = memory.model_resident_bytes(model)
    kv_bytes = 0
    cfg = model.cfg if isinstance(model, TransformerLM) else None
    if cfg is not None:
        block_tokens = envknob.get_int("DL4J_TPU_SERVE_KV_BLOCK", 16)
        if block_tokens > 0:
            blocks = memory.kv_arena_blocks(
                cfg, block_tokens, params=getattr(model, "params", None),
                hbm_gb=(hbm_gb if hbm_gb is not None
                        else memory.hbm_budget_gb()))
            # +1: physical block 0 is the trash block (serving/paged.py)
            kv_bytes = (blocks + 1) * memory.kv_block_bytes(
                cfg, block_tokens)
        else:
            slots = envknob.get_int("DL4J_TPU_SERVE_SLOTS", 4)
            # one fixed slot == one max_len-token "block"
            kv_bytes = slots * memory.kv_block_bytes(cfg, cfg.max_len)
    return ModelFootprint(name, param_bytes, kv_bytes, int(ann_bytes))


@dataclass
class PlacementPlan:
    """The audited output of :func:`pack_models`: per-replica model
    assignments, per-replica used bytes vs the budget, and the models
    that fit NOWHERE (``unplaced`` — loud, never silently dropped).
    Rendered at the router's ``/placement`` endpoint."""

    budget_bytes: int
    assignments: Dict[str, List[str]] = field(default_factory=dict)
    used_bytes: Dict[str, int] = field(default_factory=dict)
    footprints: Dict[str, Dict[str, int]] = field(default_factory=dict)
    unplaced: List[str] = field(default_factory=list)

    def replicas_of(self, model: str) -> List[str]:
        return [rid for rid in sorted(self.assignments)
                if model in self.assignments[rid]]

    def models(self) -> List[str]:
        out = set(self.unplaced)
        for names in self.assignments.values():
            out.update(names)
        return sorted(out)

    def describe(self) -> Dict[str, Any]:
        return {
            "budget_bytes": int(self.budget_bytes),
            "assignments": {r: list(v)
                            for r, v in sorted(self.assignments.items())},
            "used_bytes": {r: int(v)
                           for r, v in sorted(self.used_bytes.items())},
            "utilization": {
                r: round(v / self.budget_bytes, 4)
                if self.budget_bytes else None
                for r, v in sorted(self.used_bytes.items())},
            "footprints": {n: dict(fp)
                           for n, fp in sorted(self.footprints.items())},
            "unplaced": list(self.unplaced),
        }


def pack_models(footprints: Iterable[ModelFootprint],
                replica_ids: Sequence[str], *,
                hbm_gb: Optional[float] = None,
                copies: int = 1) -> PlacementPlan:
    """First-fit-decreasing bin-pack: models sorted by (-total_bytes,
    name), replicas visited in sorted-rid order, each model landing on
    the first ``copies`` replicas with headroom. Both sort keys are
    total orders, so the plan is a deterministic function of
    (footprints, replica_ids, budget) — same inputs, same plan,
    bit-exact. A model too big for ANY replica lands in ``unplaced``
    (the router turns an unplaced/zero-ready model into a loud 503)."""
    budget = int((hbm_gb if hbm_gb is not None
                  else memory.hbm_budget_gb()) * 2.0**30)
    rids = sorted(str(r) for r in replica_ids)
    plan = PlacementPlan(budget_bytes=budget,
                         assignments={r: [] for r in rids},
                         used_bytes={r: 0 for r in rids})
    copies = max(1, int(copies))
    ordered = sorted(footprints, key=lambda f: (-f.total_bytes, f.name))
    for fp in ordered:
        plan.footprints[fp.name] = fp.describe()
        placed = 0
        for rid in rids:
            if placed >= copies:
                break
            if plan.used_bytes[rid] + fp.total_bytes <= budget:
                plan.assignments[rid].append(fp.name)
                plan.used_bytes[rid] += fp.total_bytes
                placed += 1
        if placed == 0:
            plan.unplaced.append(fp.name)
    return plan
