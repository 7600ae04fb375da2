"""Per-lane token sampling (counterpart: ``deeplearning4j_tpu/serving/decode.py``
``_sample_step`` :119). ``ContinuousDecoder`` (the fixed slot pool behind
``DL4J_TPU_SERVE_KV_BLOCK=0``) and k-step ticks wait for a later slice.

Greedy lanes (temperature <= 0) take the argmax. A sampled lane draws a
categorical sample from ``softmax(logits / temperature)`` as
``argmax(logits / T + Gumbel noise)``, its uniforms drawn from the
request's own ``torch.Generator`` — seeded from the request's seed and
advanced once per generated token. So a request's tokens do not depend on
the lanes beside it, and a preempted request goes on with the same stream.
The bits differ from ``jax.random``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _sample_step(logits: torch.Tensor, temps: Sequence[float],
                 gens: Sequence[Optional[torch.Generator]]) -> torch.Tensor:
    """logits [S, V] f32; temps [S] (host floats); gens [S] generators
    (used only where temps > 0) -> next tokens [S] int64 on the device."""
    nxt = torch.argmax(logits, dim=-1)
    lanes = [i for i, t in enumerate(temps) if t > 0]
    if lanes:
        v = logits.shape[1]
        u = torch.stack([torch.rand((v,), generator=gens[i],
                                    device=logits.device) for i in lanes])
        gumbel = -torch.log(-torch.log(u))
        t = torch.tensor([max(float(temps[i]), 1e-6) for i in lanes],
                         dtype=logits.dtype, device=logits.device)
        idx = torch.tensor(lanes, dtype=torch.long, device=logits.device)
        nxt[idx] = torch.argmax(logits[idx] / t[:, None] + gumbel, dim=-1)
    return nxt
