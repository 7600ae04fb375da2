"""Flash-attention forward, K4 of the port (counterpart:
``deeplearning4j_tpu/ops/pallas_attention.py`` — ``_flash_raw`` and its
kernel body ``_flash_kernel``, reached through ``flash_attention`` and
``attention_auto``).

Three things live here:

* :func:`flash_attention_plain` — the plain PyTorch version: dense masked
  softmax in f32. The CPU path and the card's equivalence oracle.
* :func:`flash_attention` — the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor goes to the hand-written kernel
  ``csrc/flash_attention.cu`` or the wrapper raises. There is no fallback
  on the card.
* a launch counter on each: ``flash_attention.launches`` counts kernel
  launches only, ``flash_attention_plain.launches`` counts plain calls.

Source note. Replaces the TPU kernel ``_flash_kernel``. At the serving
shapes (T <= 1024, D = 64, bf16) memory sets the card's bound (~5 us at
T=1024, H=32 against 3.35 TB/s); this first kernel does its products with
f32 FMAs out of shared memory, so the FMA rate bounds it in practice. The
design (see the .cu header): one CTA per (64-row q tile, n*h), K/V tiles
of 64 keys streamed through shared memory up to the diagonal, online
softmax in f32 registers, ragged T masked in the kernel so every bucket
width runs through it, and [N,T,H,D] read through its strides without
head-folding transposes. The backward (``_flash_bwd``) comes with the
training slice.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURE = {"flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                      _I, _I, _I, _P]}


def flash_attention_plain(q, k, v, *, causal: bool = False):
    """q, k, v [N, T, H, D] -> (o [N, T, H, D] in q's dtype, lse [N, H, T]
    f32): f32 scores scaled by 1/sqrt(D), causal mask, softmax, f32
    p @ v. The same function as the kernel, materialising the scores."""
    flash_attention_plain.launches += 1
    n, t, h, d = q.shape
    qf = q.float().permute(0, 2, 1, 3) * (1.0 / (d ** 0.5))
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    s = qf @ kf.transpose(-1, -2)                       # [N, H, T, T]
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                    # [N, H, T]
    p = torch.softmax(s, dim=-1)
    o = (p @ vf).permute(0, 2, 1, 3).to(q.dtype)
    return o.contiguous(), lse


flash_attention_plain.launches = 0


def _lib():
    return build.load("flash_attention", _SIGNATURE)


def flash_attention(q, k, v, *, causal: bool = False):
    """q, k, v [N, T, H, D] -> (o [N, T, H, D] in q's dtype, lse [N, H, T]
    f32). CPU tensors: :func:`flash_attention_plain`. CUDA tensors: the
    hand-written kernel, or an exception."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    n, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} differ")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head size {d} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes matching f32 or bf16")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, "
                             f"q on {q.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last axis must "
                             "be contiguous")
    o = torch.empty((n, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, t), dtype=torch.float32, device=q.device)
    lib = _lib()
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), n, t, h, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), _DTYPE_CODE[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
