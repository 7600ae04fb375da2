"""Device resolution for the port's entry points (no JAX counterpart: the
JAX package takes its device from the backend).

``TransformerLM``, ``PagedDecoder`` and ``ServingEngine`` run on ``cuda``
unless the caller passes ``device="cpu"``. With no card they raise; they
never move to the CPU on their own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # f32 matmuls and convolutions stay full f32 on the card: the
        # tied LM head is an f32 product, and TF32 would keep only ~3
        # decimal digits of it (PyTorch's cuDNN default allows TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
