"""The multi-process runtime (counterpart:
``deeplearning4j_tpu/parallel/multihost.py`` — the env contract
:27-29, ``MultiHostConfig.from_env`` :43, ``initialize_multihost`` :61,
``is_multihost``, ``is_primary`` :88, ``process_info`` :116,
``local_batch_slice`` :127, ``put_batch`` :170).

Where the JAX package brings up ``jax.distributed`` from a coordinator
triple, the port brings up ``torch.distributed`` over a TCP store at the
same address (``DL4J_TPU_COORDINATOR`` host:port, ``DL4J_TPU_NUM_PROCESSES``,
``DL4J_TPU_PROCESS_ID``: the launchers' env contract, read through
``ops/env.py``): ``nccl`` with a card, ``gloo`` without. Every helper
degrades to one process. A process feeds only its rows of the global
batch (:func:`local_batch_slice`); a batch that does not split evenly
raises on every process alike, before any collective could wait on a
peer that failed.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops.device import resolve_device

COORDINATOR_ENV = "DL4J_TPU_COORDINATOR"
NUM_PROCESSES_ENV = "DL4J_TPU_NUM_PROCESSES"
PROCESS_ID_ENV = "DL4J_TPU_PROCESS_ID"


@dataclass
class MultiHostConfig:
    """The coordinator triple; :meth:`from_env` reads the launchers'
    env vars."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    @classmethod
    def from_env(cls) -> "MultiHostConfig":
        return cls(
            coordinator_address=envknob.raw(COORDINATOR_ENV).strip() or None,
            num_processes=envknob.get_opt_int(NUM_PROCESSES_ENV),
            process_id=envknob.get_opt_int(PROCESS_ID_ENV),
        )

    def is_configured(self) -> bool:
        return self.coordinator_address is not None


def initialize_multihost(config: Optional[MultiHostConfig] = None, *,
                         backend: Optional[str] = None,
                         timeout_s: float = 120.0) -> bool:
    """Join the process group at the configured coordinator (a
    ``tcp://`` store; process 0 hosts it) when one is configured and no
    group is up yet; returns whether multi-process mode is active. A
    no-op for an unconfigured single process, and when already up."""
    if dist.is_available() and dist.is_initialized():
        return True
    config = config or MultiHostConfig.from_env()
    if not config.is_configured():
        return False
    if config.num_processes is None or config.process_id is None:
        raise ValueError(f"{COORDINATOR_ENV} is set; {NUM_PROCESSES_ENV} "
                         f"and {PROCESS_ID_ENV} must be too")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{config.coordinator_address}",
        world_size=int(config.num_processes), rank=int(config.process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def is_multihost() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def is_primary() -> bool:
    """True on the process that owns shared-filesystem writes: process 0
    by the env contract, else rank 0 of an initialized group, else (one
    process) True."""
    pid = envknob.get_opt_int(PROCESS_ID_ENV)
    if pid is not None:
        return pid == 0
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def process_info() -> dict:
    up = dist.is_available() and dist.is_initialized()
    count = dist.get_world_size() if up else 1
    local = max(1, torch.cuda.device_count()) if torch.cuda.is_available() \
        else 1
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": count,
        "local_device_count": local,
        "global_device_count": local * count,
    }


def local_batch_slice(global_batch: int,
                      process_count: Optional[int] = None,
                      process_index: Optional[int] = None) -> slice:
    """Process i's contiguous rows of a global batch. Raises (on every
    process alike) when the batch does not split evenly over the
    processes; ``process_count``/``process_index`` override the group's
    topology."""
    if process_count is None:
        info = process_info()
        process_count = info["process_count"]
        process_index = info["process_index"]
    elif process_index is None:
        raise ValueError("process_index is required with process_count")
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} outside [0, {process_count})")
    from deeplearning4j_tpu_torch.parallel.training_master import (
        balanced_splits,
    )

    if global_batch % process_count != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{process_count} live processes — pad or trim so every "
            "process feeds an equal shard; a silent tail truncation "
            "would drop examples")
    return balanced_splits(global_batch, process_count)[process_index]


def put_batch(array, device=None) -> torch.Tensor:
    """One process's batch (its own rows: :func:`local_batch_slice`) as a
    tensor on ``device`` (the card unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    if torch.is_tensor(array):
        return array.to(dev)
    import numpy as np

    return torch.as_tensor(np.asarray(array), device=dev)
