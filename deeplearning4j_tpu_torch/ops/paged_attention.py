"""Paged-decode attention, K6 of the port (counterpart:
``deeplearning4j_tpu/ops/pallas_paged.py`` — ``paged_attention`` and its
kernel body ``_paged_kernel``).

Three things live here:

* :func:`paged_attention_plain` — the plain PyTorch version: the
  ``ck[tables]`` gather of ``serving/paged.py``'s gather path and an f32
  masked softmax. The CPU path and the card's equivalence oracle.
* :func:`paged_attention` — the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor goes to the hand-written kernel
  ``csrc/paged_attention.cu`` or the wrapper raises. There is no fallback
  on the card.
* a launch counter on each: ``paged_attention.launches`` counts kernel
  launches only, ``paged_attention_plain.launches`` counts plain calls.

Source note. Replaces the TPU kernel ``_paged_kernel``. Memory bounds it
on the card: every visible token's K and V row is read once for 4*D
flops per head. The design (see the .cu header): one CTA per (lane, group
of 4 heads), one warp per head with D/32 elements per thread; the CTA
reads ``tables[s, j]`` and ``pos[s]`` itself and walks only blocks
``j <= pos // bt``, stopping at ``pos``, with an f32 online softmax — so
it reads the visible tokens' bytes and nothing else, and the trash block
is never read by an active lane.

Mask contract (the gather path's): token ``t`` of lane ``s`` is visible
iff ``t <= pos[s]``; physical block 0 is trash and never visible.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = {"paged_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _P]}


def paged_attention_plain(q, ck, cv, tables, pos):
    """q [S, H, hd], ck/cv [NB+1, bt, H, hd], tables [S, m] int, pos [S]
    int -> att [S, H, hd] f32: gather each lane's blocks back into the
    contiguous [S, m*bt, H, hd] window, mask ``t > pos``, f32 softmax."""
    paged_attention_plain.launches += 1
    s, h, hd = q.shape
    bt = ck.shape[1]
    t_total = tables.shape[1] * bt
    idx = tables.long()
    kg = ck[idx].reshape(s, t_total, h, hd).float()
    vg = cv[idx].reshape(s, t_total, h, hd).float()
    sc = torch.einsum("nhd,nthd->nht", q.float(), kg) * (1.0 / hd ** 0.5)
    t_idx = torch.arange(t_total, device=q.device)
    visible = t_idx[None, :] <= pos.long()[:, None]              # [S, T]
    sc = sc.masked_fill(~visible[:, None, :], float("-inf"))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("nht,nthd->nhd", p, vg)


paged_attention_plain.launches = 0


def _lib():
    return build.load("paged_attention", _SIGNATURE)


def paged_attention(q, ck, cv, tables, pos):
    """Block-table decode attention: q [S, H, hd] (f32 or bf16), ck/cv
    [NB+1, bt, H, hd] arena view of one layer (block 0 = trash), tables
    [S, m] int32, pos [S] int32 -> att [S, H, hd] f32. CPU tensors:
    :func:`paged_attention_plain`. CUDA tensors: the hand-written kernel,
    or an exception."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, ck, cv, tables, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    s, h, hd = q.shape
    nb1, bt, h2, hd2 = ck.shape
    if cv.shape != ck.shape or (h2, hd2) != (h, hd):
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, ck "
                         f"{tuple(ck.shape)}, cv {tuple(cv.shape)} disagree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head size {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or ck.dtype not in _DTYPE_CODE \
            or cv.dtype != ck.dtype:
        raise ValueError(f"paged_attention: dtypes {q.dtype}/{ck.dtype}/"
                         f"{cv.dtype}; the kernel takes f32 or bf16")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_attention: tables and pos must be int32")
    if tables.shape[0] != s or pos.shape != (s,):
        raise ValueError(f"paged_attention: tables {tuple(tables.shape)} / "
                         f"pos {tuple(pos.shape)} for {s} lanes")
    for name, x in (("q", q), ("ck", ck), ("cv", cv), ("tables", tables),
                    ("pos", pos)):
        if x.device != q.device:
            raise ValueError(f"paged_attention: {name} on {x.device}, "
                             f"q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    out = torch.empty((s, h, hd), dtype=torch.float32, device=q.device)
    lib = _lib()
    rc = lib.paged_attention_fwd(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), s, h, hd, bt, tables.shape[1],
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[ck.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
