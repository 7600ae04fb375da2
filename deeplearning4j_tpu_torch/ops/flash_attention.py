"""Flash attention: K4 and K5 of the port, their backward and the dispatch
(counterpart: ``deeplearning4j_tpu/ops/pallas_attention.py`` —
``_flash_raw`` :117 with ``_flash_bwd`` :176, ``_flash_ext_raw`` :289
with ``_flash_ext_bwd`` :335, ``flash_attention_block`` :388,
``flash_attention_masked`` :449 and ``attention_auto`` :481).

Every tensor keeps the ``[N, T, H, D]`` layout; the kernels read q, k and
v through their strides, so nothing folds heads. What lives here:

* K4, :func:`flash_attention` (``csrc/flash_attention.cu``), causal or
  full attention, and its plain version :func:`flash_attention_plain`.
* K5, :func:`flash_attention_block` (``csrc/flash_attention_ext.cu``):
  K4 plus an additive key bias (a key padding mask, shared by the heads)
  and a visibility offset — key ``ki`` is visible to query ``qi`` iff
  ``qi + offset >= ki``, so ``offset = 0`` is causal, ``offset >= Tk``
  shows every key and ``offset <= -Tq`` hides every key; Tq may differ
  from Tk (a ring step attends a local Q shard to a rotating K/V shard). A
  row with no visible key gives O = 0 and lse = -inf. Its plain version
  is :func:`flash_attention_block_plain`.
* K7, :func:`flash_bwd` (``csrc/flash_bwd.cu``), the backward of both:
  dq, dk and dv from q, k, v, o, lse and the cotangents (with the lse
  cotangent, a key bias and an offset, as K5's). In the JAX package that
  backward is XLA outside any Pallas kernel; its plain version here is
  :func:`flash_block_bwd`, the JAX package's blocked backward in plain
  PyTorch, over key tiles of 128, recomputing probabilities from the saved
  lse.
* :class:`FlashBlockFn` and :class:`FlashFn`, the autograd functions: the
  forward is K5's or K4's wrapper, the backward K7's. K4's forward goes
  through one custom operator (``torch.ops.dl4j_tpu_torch.flash_attention``),
  so a selective activation checkpoint (``ops/remat.py``, ``dots``) can
  keep its output instead of launching it again.
* :func:`flash_attention_masked` and :func:`attention_auto`, the dispatch
  of the MultiHeadAttention layer: a key mask goes to K5, no mask to K4.
  The JAX package's ``_dense_masked`` route for shapes its kernels do not
  fit is not carried over: on the card a head size outside
  :data:`HEAD_DIMS` raises in the wrapper.

Each wrapper sends a CPU tensor to its plain version and a CUDA tensor to
its kernel, or raises: no fallback on the card. A launch counter sits on
each wrapper and each plain version (``.launches``; K7's wrapper counts
one per call, which launches its two passes).

Not carried over: the JAX package keeps K5 off (``kernel_gate
.measured_win``) until a TPU measurement proves it; no TPU number carries
over to the card, so here K5 is the path, as K4 and K6 are.

Source note (K4 and K5). Both sources build into one library, whose
kernels are ``csrc/flash_fwd.cuh``'s: K4's entry point calls K5's with no
key bias and offset 0 (causal) or T (full), so the two give the same bits
on the same inputs. At the
serving widths memory bounds K4 on the H100; at the ring's and the
masked layer's widths (T >= 2048) the products bound both (~1000 flops
per byte). In bf16 the products run on the tensor cores (``wgmma``, P
fed from registers), K/V tiles arrive by ``cp.async`` in a two-stage
ring, and only tiles that hide a key from some row or carry a bias test
each element; every q tile stops at its last visible key tile, since the
offset is a host integer here. In f32 (the MHA layer's fit) the products
also run on the tensor cores, by 3xTF32 on ``mma.sync``: each operand is
split into a TF32 high part and the TF32 rounding of the rest, and three
TF32 products are summed in f32, which is f32-accurate (held at 1e-4 like
the f32 path always was); TF32 alone stays off (``ops/device.py``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.ops import build
from deeplearning4j_tpu_torch.ops.dtypes import softmax_dtype

HEAD_DIMS = (16, 32, 64, 128)
BWD_BLOCK_K = 128  # the JAX package's _BLOCK_K: key tile of the backward
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# the entry points of the one library both sources build into
SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _L, _L, _L, _L, _L, _L, _L, _L, _L,
                            _I, _I, _I, _P],
    "flash_attention_ext_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                _I, _I, _I, _P]}
# K7's library: q k v o g lse glse kb dq dk dv dvec, N Tq Tk H D off dtype
# device, stream
BWD_SIGNATURES = {"flash_attention_bwd": [_P] * 12 + [_I] * 8 + [_P]}


def flash_attention_plain(q, k, v, *, causal: bool = False):
    """q, k, v [N, T, H, D] -> (o [N, T, H, D] in q's dtype, lse [N, H, T]):
    scores scaled by 1/sqrt(D) in at least f32 (f64 stays f64), causal
    mask, softmax, p @ v. The same function as the kernel, materialising
    the scores."""
    flash_attention_plain.launches += 1
    n, t, h, d = q.shape
    dt = softmax_dtype(q.dtype)
    qf = q.to(dt).permute(0, 2, 1, 3) * (1.0 / (d ** 0.5))
    kf = k.to(dt).permute(0, 2, 1, 3)
    vf = v.to(dt).permute(0, 2, 1, 3)
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
    return build.load("flash_attention", SIGNATURES)


def _check_inputs(what, q, k, v, same_t: bool):
    """Raise on what the kernels do not take; else the (n, h, d) of q and
    the [N, T, H] strides of q, k and v, in the launch's order. Kept to a
    few attribute reads: it runs on the host before every launch."""
    qs, ks = q.shape, k.shape
    if ks != v.shape or ks[0] != qs[0] or ks[2:] != qs[2:] \
            or (same_t and ks != qs):
        raise ValueError(f"{what}: q {tuple(qs)}, k {tuple(ks)}, "
                         f"v {tuple(v.shape)} do not match")
    n, _, h, d = qs
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head size {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{what}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "the kernel takes matching f32 or bf16")
    strides = (q.stride(), k.stride(), v.stride())
    for name, x, st in zip("qkv", (q, k, v), strides):
        if x is not q and x.device != q.device:
            raise ValueError(f"{what}: {name} on {x.device}, q on "
                             f"{q.device}")
        if st[3] != 1:
            raise ValueError(f"{what}: {name}'s last axis must be "
                             "contiguous")
    return (n, h, d), strides[0][:3] + strides[1][:3] + strides[2][:3]


def _stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream (the kernels
    launch on it)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def flash_attention(q, k, v, *, causal: bool = False):
    """q, k, v [N, T, H, D] -> (o [N, T, H, D] in q's dtype, lse [N, H, T]
    f32). CPU tensors: :func:`flash_attention_plain`. CUDA tensors: the
    hand-written kernel, or an exception."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    (n, h, d), strides = _check_inputs("flash_attention", q, k, v,
                                       same_t=True)
    t = q.shape[1]
    dev = q.device
    o = torch.empty((n, t, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((n, h, t), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), n, t, h, d, *strides, int(bool(causal)),
        _DTYPE_CODE[q.dtype], dev.index, _stream(dev))
    build.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# K5: additive key bias + visibility offset
# ---------------------------------------------------------------------------


def key_keep(key_mask):
    """[N, Tk] 0/1 (or bool) key mask -> bool, True where a key is kept."""
    return key_mask if key_mask.dtype == torch.bool else key_mask != 0


def key_bias(key_mask, dtype=torch.float32):
    """[N, Tk] 0/1 (or bool) key mask -> additive bias: 0 keeps, -inf
    masks."""
    keep = key_keep(key_mask)
    zero = torch.zeros((), dtype=dtype, device=keep.device)
    return torch.where(keep, zero, torch.full_like(zero, float("-inf")))


def _visible(tq: int, k0: int, k1: int, offset: int, device):
    """[Tq, k1 - k0] bool: qi + offset >= ki for keys k0..k1-1."""
    qi = torch.arange(tq, device=device)[:, None]
    ki = torch.arange(k0, k1, device=device)[None, :]
    return qi + offset >= ki


def flash_attention_block_plain(q, k, v, *, offset: int, key_mask=None):
    """q [N, Tq, H, D], k, v [N, Tk, H, D], key_mask [N, Tk] 0/1 or None ->
    (o [N, Tq, H, D] in q's dtype, lse [N, H, Tq]). A dense masked softmax
    in at least f32 (f64 stays f64): scores q.k / sqrt(D) plus the key
    bias, keys with qi + offset < ki hidden; a row with no visible key
    gives O = 0 and lse = -inf. The same function as K5, materialising
    the scores."""
    flash_attention_block_plain.launches += 1
    n, tq, h, d = q.shape
    tk = k.shape[1]
    dt = softmax_dtype(q.dtype)
    qf = q.to(dt).permute(0, 2, 1, 3) * (1.0 / (d ** 0.5))
    kf = k.to(dt).permute(0, 2, 1, 3)
    vf = v.to(dt).permute(0, 2, 1, 3)
    s = qf @ kf.transpose(-1, -2)                       # [N, H, Tq, Tk]
    if key_mask is not None:
        s = s + key_bias(key_mask, dt)[:, None, None, :]
    s = s.masked_fill(~_visible(tq, 0, tk, int(offset), q.device),
                      float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                    # -inf: none visible
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse,
                                  torch.zeros_like(lse))[..., None])
    o = (p @ vf).permute(0, 2, 1, 3).to(q.dtype)
    return o.contiguous(), lse


flash_attention_block_plain.launches = 0


def flash_attention_block(q, k, v, *, offset: int, key_mask=None):
    """q [N, Tq, H, D], k, v [N, Tk, H, D], key_mask [N, Tk] 0/1 or None,
    offset a host integer -> (o [N, Tq, H, D] in q's dtype, lse [N, H, Tq]
    f32). CPU tensors: :func:`flash_attention_block_plain`. CUDA tensors:
    the hand-written kernel K5, or an exception."""
    if q.device.type == "cpu":
        return flash_attention_block_plain(q, k, v, offset=offset,
                                           key_mask=key_mask)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention_block: unsupported device {q.device}")
    (n, h, d), strides = _check_inputs("flash_attention_block", q, k, v,
                                       same_t=False)
    tq, tk = q.shape[1], k.shape[1]
    kb = None
    if key_mask is not None:
        if tuple(key_mask.shape) != (n, tk) \
                or key_mask.device != q.device:
            raise ValueError(
                f"flash_attention_block: key_mask {tuple(key_mask.shape)} "
                f"on {key_mask.device}, expected ({n}, {tk}) on {q.device}")
        kb = key_bias(key_mask).contiguous()
    # offsets past either end give the same function as the ends
    off = max(-tq, min(tk, int(offset)))
    o = torch.empty((n, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, tq), dtype=torch.float32, device=q.device)
    lib = _lib()
    rc = lib.flash_attention_ext_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kb is None else kb.data_ptr(), o.data_ptr(),
        lse.data_ptr(), n, tq, tk, h, d, *strides, off,
        _DTYPE_CODE[q.dtype], q.device.index, _stream(q.device))
    build.check(lib, rc, "flash_attention_block")
    flash_attention_block.launches += 1
    return o, lse


flash_attention_block.launches = 0


# ---------------------------------------------------------------------------
# the blocked backward (plain PyTorch, as the JAX package's is XLA)
# ---------------------------------------------------------------------------


def flash_block_bwd(q, k, v, key_mask, offset: int, o, lse, g, g_lse=None):
    """(dq, dk, dv) of ``(o, lse) = flash_attention_block(q, k, v, ...)``
    for the cotangents g [N, Tq, H, D] and g_lse [N, H, Tq] (or None), by
    the JAX package's ``_flash_ext_bwd``: probabilities recomputed per
    tile of ``BWD_BLOCK_K`` keys from the saved lse, never the [Tq, Tk]
    score matrix; dS = P * (dP - D + g_lse) / sqrt(D). Math in at least
    f32; gradients in the inputs' dtypes. Masked and invisible keys have
    P = 0, hence zero dK and dV. K7's plain version."""
    flash_block_bwd.launches += 1
    n, tq, h, d = q.shape
    tk = k.shape[1]
    dt = softmax_dtype(q.dtype)
    scale = 1.0 / math.sqrt(d)
    heads = lambda a: a.to(dt).permute(0, 2, 1, 3)      # [N, H, T, D]
    qf, kf, vf, gf = heads(q), heads(k), heads(v), heads(g)
    dvec = (gf * heads(o)).sum(-1)                      # [N, H, Tq]
    if g_lse is not None:
        dvec = dvec - g_lse.to(dt)
    lse = lse.to(dt)
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    kb = None if key_mask is None else key_bias(key_mask, dt)
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for k0 in range(0, tk, BWD_BLOCK_K):
        k1 = min(tk, k0 + BWD_BLOCK_K)
        ks, vs = kf[:, :, k0:k1], vf[:, :, k0:k1]
        s = (qf @ ks.transpose(-1, -2)) * scale         # [N, H, Tq, b]
        if kb is not None:
            s = s + kb[:, None, None, k0:k1]
        s = s.masked_fill(~_visible(tq, k0, k1, int(offset), q.device),
                          float("-inf"))
        p = torch.exp(s - lse_safe[..., None])          # hidden -> 0
        dv[:, :, k0:k1] = p.transpose(-1, -2) @ gf
        ds = p * (gf @ vs.transpose(-1, -2) - dvec[..., None]) * scale
        dq += ds @ ks
        dk[:, :, k0:k1] = ds.transpose(-1, -2) @ qf
    back = lambda a, like: a.permute(0, 2, 1, 3).to(like.dtype).contiguous()
    return back(dq, q), back(dk, k), back(dv, v)


flash_block_bwd.launches = 0


def _aligned(x):
    """``x`` contiguous and 16-byte aligned (K7 copies 16 bytes at a
    time)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_bwd(q, k, v, key_mask, offset: int, o, lse, g, g_lse=None):
    """(dq, dk, dv) of ``(o, lse) = flash_attention_block(q, k, v,
    offset=offset, key_mask=key_mask)`` (K4's with no mask and offset 0 or
    T) for the cotangents g [N, Tq, H, D] and g_lse [N, H, Tq] or None.
    CPU tensors: :func:`flash_block_bwd`. CUDA tensors: the hand-written
    kernel K7, or an exception. Gradients in the inputs' dtype."""
    if q.device.type == "cpu":
        return flash_block_bwd(q, k, v, key_mask, offset, o, lse, g, g_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    (n, h, d), _ = _check_inputs("flash_bwd", q, k, v, same_t=False)
    tq, tk = q.shape[1], k.shape[1]
    if o.shape != q.shape or g.shape != q.shape or o.dtype != q.dtype \
            or o.device != q.device or g.device != q.device:
        raise ValueError(f"flash_bwd: o {tuple(o.shape)} {o.dtype}, g "
                         f"{tuple(g.shape)} do not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, x in (("lse", lse), ("g_lse", g_lse)):
        if x is not None and (tuple(x.shape) != (n, h, tq)
                              or x.device != q.device):
            raise ValueError(f"flash_bwd: {name} {tuple(x.shape)} on "
                             f"{x.device}, expected ({n}, {h}, {tq}) on "
                             f"{q.device}")
    kb = None
    if key_mask is not None:
        if tuple(key_mask.shape) != (n, tk) or key_mask.device != q.device:
            raise ValueError(
                f"flash_bwd: key_mask {tuple(key_mask.shape)} on "
                f"{key_mask.device}, expected ({n}, {tk}) on {q.device}")
        kb = key_bias(key_mask).contiguous()
    q, k, v, o = (_aligned(x) for x in (q, k, v, o))
    g = _aligned(g.to(q.dtype))
    lse = lse.float().contiguous()
    if g_lse is not None:
        g_lse = g_lse.float().contiguous()
    off = max(-tq, min(tk, int(offset)))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dvec = torch.empty((n, h, tq), dtype=torch.float32, device=q.device)
    lib = build.load("flash_bwd", BWD_SIGNATURES)
    rc = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        g.data_ptr(), lse.data_ptr(),
        None if g_lse is None else g_lse.data_ptr(),
        None if kb is None else kb.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dvec.data_ptr(), n, tq, tk, h, d, off,
        _DTYPE_CODE[q.dtype], q.device.index, _stream(q.device))
    build.check(lib, rc, "flash_bwd")
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


@torch.library.custom_op("dl4j_tpu_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's wrapper as one operator: a selective checkpoint sees it as one
    op and can keep its outputs (``ops/remat.saved_ops``)."""
    return flash_attention(q, k, v, causal=causal)


class FlashBlockFn(torch.autograd.Function):
    """``(o, lse) = FlashBlockFn.apply(q, k, v, key_mask, offset)``: K5
    (its plain version on the CPU) forward, K7 (:func:`flash_block_bwd` on
    the CPU) backward with the lse cotangent (ring callers combine shards
    through lse). No gradient reaches the mask or the offset."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, offset):
        o, lse = flash_attention_block(q, k, v, offset=offset,
                                       key_mask=key_mask)
        ctx.save_for_backward(q, k, v, key_mask, o, lse)
        ctx.offset = int(offset)
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, key_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, key_mask, ctx.offset, o, lse, g,
                               g_lse)
        return dq, dk, dv, None, None


class FlashFn(torch.autograd.Function):
    """``o = FlashFn.apply(q, k, v, causal)``: K4 (its plain version on the
    CPU) forward, K7 (:func:`flash_block_bwd` on the CPU) backward, as the
    JAX package's ``_flash_bwd``: no key bias, offset 0 (causal) or T
    (full), no lse cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = torch.ops.dl4j_tpu_torch.flash_attention(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.offset = 0 if causal else k.shape[1]
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, None, ctx.offset, o, lse, g)
        return dq, dk, dv, None


# ---------------------------------------------------------------------------
# the single-device dispatch of the MultiHeadAttention layer
# ---------------------------------------------------------------------------


def flash_attention_masked(q, k, v, key_mask, *, causal: bool = False):
    """q, k, v [N, T, H, D], key_mask [N, T] 0/1 -> [N, T, H, D]: attention
    with padded keys left out of the softmax, through K5 (offset 0 when
    causal, T otherwise). Differentiable through :class:`FlashBlockFn`."""
    t = q.shape[1]
    o, _ = FlashBlockFn.apply(q, k, v, key_mask, 0 if causal else t)
    return o


def attention_auto(q, k, v, *, causal: bool = False, key_mask=None):
    """q, k, v [N, T, H, D] -> [N, T, H, D]. A key mask ([N, T] 0/1) goes
    to K5 (:func:`flash_attention_masked`), no mask to K4 (:class:`FlashFn`);
    the CPU runs their plain versions through the same functions."""
    if key_mask is not None:
        return flash_attention_masked(q, k, v, key_mask, causal=causal)
    return FlashFn.apply(q, k, v, causal)
