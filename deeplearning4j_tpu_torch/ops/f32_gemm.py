"""K8: f32 matrix products at f32 accuracy on the H100's tensor cores, and
the tied head that runs through them (no JAX counterpart kernel: the JAX
package leaves ``h @ embed.T`` in ``models/transformer.py`` ``_head`` and
``models/bert.py`` ``mlm_logits`` to XLA).

What lives here:

* :func:`f32_gemm` (``csrc/f32_gemm.cu``): ``a [M, K] @ b [K, N]`` in f32
  by 3xTF32 on ``wgmma``, and its plain version :func:`f32_gemm_plain`.
  ``a`` is read through its strides where one of them is 1 (K-major or
  M-major); ``b`` is packed (split into TF32 high and low parts, K-major
  tiles) by a pre-pass inside each call. Held to the f32 bars: each
  operand is split into a TF32 high part and the TF32 rounding of the
  rest, three TF32 products are summed in f32, every 32 of k are summed
  on the tensor cores from zero and added in f32 on the CUDA cores, and
  a k longer than 256 stages of 32 is cut into slices (split-K, see
  :func:`slice_stages`) added in order by a second launch. TF32 alone
  stays off (``ops/device.py``).
* :func:`tied_head`: the tied LM head ``h @ embed.T`` for ``h [..., d]``
  and ``embed [V, d]``. On the card an f32 ``h`` of at least
  :data:`MIN_ROWS` rows goes through :class:`TiedHeadFn`, whose forward
  (``h @ embed.T``) and backward (``dh = G @ embed``, ``dembed = G^T @
  h``) are K8; any other card product (f64 for the gradient checks, bf16,
  a decode step's few rows) is counted in ``tied_head.declined``. What K8
  does not take, CPU tensors included, goes to :func:`tied_head_plain`,
  the same ``h @ embed.T`` as before, bit for bit.

Launch counters: ``f32_gemm.launches`` and ``f32_gemm_plain.launches`` (one
per product), ``tied_head.launches`` (K8 products of the head: one per
forward, two per backward), ``tied_head_plain.launches`` and
``tied_head.declined`` (one per call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deeplearning4j_tpu_torch.ops import build

# rows of h from which the head's three products run faster through K8
# than through torch's f32 matmul on an H100 80GB HBM3 (chip_smoke.py's K8
# phase: K8 lost at 64 and 128 rows, where the pack of the embedding and
# the copy of the gradient outweigh the products, and won from 256 at
# GPT-2-medium's and BERT-base's heads); a property of the kernel and the
# card, not a setting
MIN_ROWS = 256
_BM, _BN, _BK = 128, 128, 32  # csrc/f32_gemm.cu: output tile, stage of k
# k stages summed in one f32 sequence at most: longer products are cut
# into k slices (split-K), summed in order by a second launch
_SLICE_STAGES = 256
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
SIGNATURES = {
    "f32_gemm_pack": [_P, _P, _P, _I, _I, _L, _L, _I, _P],
    "f32_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _I, _P]}


def f32_gemm_plain(a, b):
    """``a [M, K] @ b [K, N]``: the function K8 computes, in plain
    PyTorch (the card's oracle)."""
    f32_gemm_plain.launches += 1
    return a @ b


f32_gemm_plain.launches = 0


def _strides(x):
    """``(x, row stride, column stride)`` for a 2-D ``x`` with one of them
    1 (the two layouts the kernels read), else for a contiguous copy."""
    s0, s1 = x.stride()
    if s1 == 1 or x.shape[1] == 1:
        return x, s0, 1
    if s0 == 1 or x.shape[0] == 1:
        return x, 1, s1
    x = x.contiguous()
    return x, x.stride(0), 1


def aligned(a):
    """``a [M, K]`` as K8 reads its A operand: one unit stride, a 16-byte
    aligned start and the other stride a multiple of 4 floats; else a copy
    with its rows (along the unit stride) padded to 4 floats, viewed back
    to ``a``'s shape and layout (the logits' gradient, rows of V floats,
    is copied once for both of the head's backward products)."""
    a, sm, sk = _strides(a)
    rows = a if sk == 1 else a.T  # the unit stride last
    if rows.data_ptr() % 16 or rows.stride(0) % 4:
        n, length = rows.shape
        pad = torch.empty((n, -(-length // 4) * 4), dtype=rows.dtype,
                          device=rows.device)
        rows = pad[:, :length]
        rows.copy_(a if sk == 1 else a.T)
    return rows if sk == 1 else rows.T


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def slice_stages(m: int, n: int, k: int, sms: int) -> int:
    """k stages (of 32) in each k slice of K8's product: at most
    :data:`_SLICE_STAGES` (the f32 sums' length), and fewer, down to 8,
    where the output tiles leave SMs idle."""
    stages = -(-k // _BK)
    tiles = -(-m // _BM) * -(-n // _BN)
    slices = max(1, -(-stages // _SLICE_STAGES),
                 min(-(-sms // tiles), stages // 8))
    return -(-stages // slices)


def f32_gemm(a, b):
    """``a [M, K] @ b [K, N]`` -> a contiguous [M, N], all f32, on the
    card: K8 (the pack of ``b``, then the product), or an exception."""
    if a.device.type != "cuda":
        raise ValueError(f"f32_gemm: unsupported device {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"f32_gemm: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not multiply")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"f32_gemm: dtypes {a.dtype}/{b.dtype}; the "
                         "kernel takes f32")
    if b.device != a.device:
        raise ValueError(f"f32_gemm: b on {b.device}, a on {a.device}")
    (m, k), n = a.shape, b.shape[1]
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"f32_gemm: a dimension of ({m}, {k}, {n}) "
                         "passes 2**31")
    dev = a.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    a, a_sm, a_sk = _strides(aligned(a))
    bt, b_sn, b_sk = _strides(b.T)  # element (n, k) of B at n b_sn + k b_sk
    packed = -(-n // _BN) * -(-k // _BK) * _BN * _BK
    parts = torch.empty((2, packed), dtype=torch.float32, device=dev)
    kts = slice_stages(m, n, k, _sms(dev.index))
    slices = -(-(-(-k // _BK)) // kts)
    ws = (torch.empty((slices, m, n), dtype=torch.float32, device=dev)
          if slices > 1 else None)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    lib = build.load("f32_gemm", SIGNATURES)
    rc = lib.f32_gemm_pack(bt.data_ptr(), parts[0].data_ptr(),
                           parts[1].data_ptr(), n, k, b_sn, b_sk, dev.index,
                           stream)
    build.check(lib, rc, "f32_gemm_pack")
    rc = lib.f32_gemm(a.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
                      out.data_ptr(), None if ws is None else ws.data_ptr(),
                      m, n, k, a_sm, a_sk, n, kts, dev.index, stream)
    build.check(lib, rc, "f32_gemm")
    f32_gemm.launches += 1
    return out


f32_gemm.launches = 0


def tied_head_plain(h, embed):
    """``h [..., d] @ embed [V, d].T`` in plain PyTorch: the head's product
    as the models wrote it (the CPU's and every declined product)."""
    tied_head_plain.launches += 1
    return h @ embed.T


tied_head_plain.launches = 0


class TiedHeadFn(torch.autograd.Function):
    """``logits = TiedHeadFn.apply(h, embed)``: ``h [..., d] @ embed.T``
    forward, ``dh = G @ embed`` and ``dembed = G^T @ h`` backward, each a
    K8 product (f32, CUDA)."""

    @staticmethod
    def forward(ctx, h, embed):
        ctx.save_for_backward(h, embed)
        out = f32_gemm(h.reshape(-1, h.shape[-1]), embed.T)
        tied_head.launches += 1
        return out.view(*h.shape[:-1], embed.shape[0])

    @staticmethod
    def backward(ctx, g):
        h, embed = ctx.saved_tensors
        g = aligned(g.reshape(-1, embed.shape[0]))
        dh = dembed = None
        if ctx.needs_input_grad[0]:
            dh = f32_gemm(g, embed).view(h.shape)
            tied_head.launches += 1
        if ctx.needs_input_grad[1]:
            dembed = f32_gemm(g.T, h.reshape(-1, h.shape[-1]))
            tied_head.launches += 1
        return dh, dembed


def takes(h, embed) -> bool:
    """The shape rule of :func:`tied_head` on the card: f32 ``h`` and
    ``embed`` with at least :data:`MIN_ROWS` rows of ``h`` go to K8."""
    return (h.dtype == torch.float32 and embed.dtype == torch.float32
            and h.numel() >= MIN_ROWS * h.shape[-1] > 0)


def tied_head(h, embed):
    """The tied head ``h [..., d] @ embed [V, d].T`` -> [..., V]. On the
    card, by what the inputs show (:func:`takes`): K8
    (:class:`TiedHeadFn`), or a decline, counted in ``tied_head.declined``.
    CPU tensors and declined products: :func:`tied_head_plain`."""
    if h.device.type != "cpu":
        if takes(h, embed):
            return TiedHeadFn.apply(h, embed)
        tied_head.declined += 1
    return tied_head_plain(h, embed)


tied_head.launches = 0
tied_head.declined = 0
