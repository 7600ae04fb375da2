"""The program under test for the ``mellum_lm`` configurations: the
port's ``TransformerLM`` with its extended options (GQA, RoPE and YaRN,
sliding windows, RMSNorm, an untied head, SwiGLU experts held here),
built around the benchmark's weights as a configuration's ``model``
block runs them, and the port's expert-layer counters. With
``programs.py``, the only place the drivers reach into
``deeplearning4j_tpu_torch``."""

from __future__ import annotations

from typing import Dict

FULL = "full_attention"


def yarn_of(rope: Dict) -> tuple:
    """The port's ``rope_yarn`` from a ``rope_parameters`` group: (factor,
    original positions, beta_fast, beta_slow, attention_factor) of its
    full layers' YaRN, or () for the default rotation."""
    full = rope[FULL]
    if full.get("rope_type", "default") != "yarn":
        return ()
    return (float(full["factor"]),
            int(full["original_max_position_embeddings"]),
            float(full["beta_fast"]), float(full["beta_slow"]),
            float(full["attention_factor"]))


def mellum_config(model: Dict, seed: int):
    """The port's ``ExtendedConfig`` of a ``mellum_lm`` model block."""
    from deeplearning4j_tpu_torch.models.transformer import ExtendedConfig

    thetas = {float(r["rope_theta"]) for r in model["rope"].values()}
    if len(thetas) != 1:
        raise ValueError(f"one rope_theta for every layer type, not {thetas}")
    return ExtendedConfig(
        vocab_size=model["vocab_size"], d_model=model["d_model"],
        n_layers=model["n_layers"], n_heads=model["n_heads"],
        d_ff=model["d_ff"], max_len=model["max_len"],
        moe_experts=model["experts"], moe_top_k=model["top_k"],
        moe_aux_coef=model["aux_coef"], dtype_policy=model["dtype_policy"],
        learning_rate=model["learning_rate"], seed=seed % 2**63,
        use_flash=model["use_flash"], remat=model["remat"],
        head_dim=model["head_dim"], n_kv_heads=model["n_kv_heads"],
        norm_eps=model["rms_eps"],
        rope_theta=thetas.pop(), rope_yarn=yarn_of(model["rope"]),
        layer_types=tuple(model["layer_types"]),
        sliding_window=model["sliding_window"],
        moe_experts_held=model["experts_held"],
        moe_expert_offset=model["expert_offset"])


def mellum_lm(model: Dict, seed: int, device, params):
    """``models/transformer.TransformerLM`` around ``params``."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(mellum_config(model, seed), device=device,
                         params=params)


def _counter(name: str) -> float:
    """The port's counter ``name``, the held-expert layer's brought up to
    date first (a wait for the card)."""
    from deeplearning4j_tpu_torch.models.transformer import expert_counters
    from deeplearning4j_tpu_torch.obs.registry import default_registry

    expert_counters()
    counters = default_registry().snapshot()["counters"]
    return float(counters.get(name, {}).get("_", 0.0))


def routed_rows() -> float:
    """The port's ``moe.routed_rows`` counter: rows the held experts have
    computed in this process, forward passes only."""
    return _counter("moe.routed_rows")


def dropped_rows() -> float:
    """The port's ``moe.dropped_rows`` counter."""
    return _counter("moe.dropped_rows")


class RecordRoutes:
    """A context in which every forward call of the port's held-expert
    layer also records its chosen experts [T, k] (recomputed from its
    inputs exactly as it routes, without gradients) into ``routes``; a
    checkpoint's recompute records nothing."""

    def __init__(self):
        self.routes = []

    def __enter__(self):
        import torch

        from deeplearning4j_tpu_torch.ops.dtypes import softmax_dtype
        from deeplearning4j_tpu_torch.parallel import expert_parallel as ep

        self._ep, self._orig = ep, ep.moe_ffn_held
        orig = self._orig

        def recording(x, Wr, W1, W2, *, top_k_, expert_offset=0):
            if not ep.in_backward():
                with torch.no_grad():
                    acc = softmax_dtype(x.dtype)
                    gates = torch.softmax(x.to(acc) @ Wr.to(acc), dim=-1)
                    self.routes.append(ep.top_k(gates, top_k_)[1])
            return orig(x, Wr, W1, W2, top_k_=top_k_,
                        expert_offset=expert_offset)

        ep.moe_ffn_held = recording
        return self

    def __exit__(self, *exc):
        self._ep.moe_ffn_held = self._orig
        return False
