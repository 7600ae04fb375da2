"""Fused skip-gram negative-sampling step, K3 of the port (counterpart:
``deeplearning4j_tpu/ops/pallas_sgns.py`` — ``sgns_fused_step`` with its
body ``_sgns_kernel``; the function it computes is
``deeplearning4j_tpu/nlp/word2vec.py`` ``_neg_body``, whose collision
scales are ``_mean_scale``).

What lives here:

* :func:`mean_scale` — the 1/sqrt(k) scale of a row hit k times by live
  updates in one batch (a copy of ``word2vec._mean_scale``).
* :func:`sgns_step_plain` — ``_neg_body`` in PyTorch, in the input's
  dtype: every gather at the stale values, ``MAX_EXP`` saturation keyed
  on the dot, then ``index_add_`` (the ``.at[].add()`` collision
  semantics) with the scales. The CPU path and the card's oracle.
* :func:`sgns_step` — the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor goes to the hand-written kernel
  ``csrc/sgns.cu`` or the wrapper raises. There is no fallback on the
  card.
* a launch counter on each: ``sgns_step.launches`` counts kernel calls
  only, ``sgns_step_plain.launches`` plain calls.

Both update syn0 [V, D] and syn1neg [V, D] in place and return them: the
port's counterpart of the TPU kernel's ``input_output_aliases``. contexts
[B] are syn0 rows; targets [B, K+1] are syn1neg rows, column 0 the center
word (label 1) and the rest negatives (label 0); live [B, K+1] masks dead
negatives and padded pairs; alpha is a float or a 0-d tensor.

Source note. Replaces the TPU kernel ``_sgns_kernel``. Memory bounds it
on the H100: each distinct row a live pair touches (at most B context
rows of syn0 and B*(K+1) rows of syn1neg) is read once and written once,
at most 4*(2*B*D + 2*B*(K+1)*D) bytes, for about 6*B*(K+1)*D flops. The design (see the .cu header): one warp per
pair with D across its lanes, three launches on the caller's stream —
the stale gathers, dot, saturated coefficient and neu1e with the row
counts of the collision scales taken by atomics; the scaled
contributions added with float atomics into a zeroed [V, D] buffer per
table; each touched row's sum added to its table once, the buffers reset
where they were touched, so they are zeroed once and never swept.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch.ops import build

MAX_EXP = 6.0  # word2vec.c's sigmoid table range; dots past it saturate
MAX_DIM = 512  # the kernel holds D / 32 elements per lane, at most 16
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = {"sgns_step": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_float,
                            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P]}

_work_lock = threading.Lock()
# per device: the two [V] count buffers and the two [V*D] delta buffers
_work: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}


def mean_scale(n_rows: int, idx, live):
    """live / sqrt(max(k, 1)), where k sums ``live`` over the entries of
    ``idx`` that name the same row: a batch's k stale updates of one row
    then move it by sqrt(k) steps, not k. The counts and their square
    root are f32 whatever the dtype of ``live``, as in the JAX package."""
    counts = torch.zeros((n_rows,), dtype=torch.float32, device=live.device)
    counts.index_add_(0, idx.reshape(-1), live.reshape(-1).float())
    return live / torch.sqrt(torch.clamp_min(counts[idx], 1.0))


def sgns_step_plain(syn0, syn1neg, contexts, targets, labels, live, alpha):
    """``_neg_body`` in the input's dtype, updating both tables in place."""
    sgns_step_plain.launches += 1
    l1 = syn0[contexts]                                  # [B, D]
    s1 = syn1neg[targets]                                # [B, K+1, D]
    dot = torch.einsum("bd,bkd->bk", l1, s1)
    f = torch.sigmoid(dot)
    base = torch.where(dot > MAX_EXP, labels - 1.0,
                       torch.where(dot < -MAX_EXP, labels, labels - f))
    g = base * alpha * live                              # [B, K+1]
    neu1e = torch.einsum("bk,bkd->bd", g, s1)
    t_scale = mean_scale(syn1neg.shape[0], targets, live)
    syn1neg.index_add_(0, targets.reshape(-1),
                       ((g * t_scale)[..., None] * l1[:, None, :])
                       .reshape(-1, l1.shape[1]))
    ctx_live = (live.sum(dim=1) > 0).float()  # f32, as in the JAX package
    ctx_scale = mean_scale(syn0.shape[0], contexts, ctx_live)
    syn0.index_add_(0, contexts, ctx_scale[:, None] * neu1e)
    return syn0, syn1neg


sgns_step_plain.launches = 0


def _workspace(dev: torch.device, v: int, d: int):
    """The kernel's zeroed buffers on ``dev``: counts of syn1neg and syn0
    rows [V], and the update of each table [V*D]. Each call leaves them
    zero again (it resets only what it touched), so they are allocated
    once per device and size, and grown when a larger table comes. The
    caller holds ``_work_lock`` until its launches are enqueued."""
    bufs = _work.get(dev)
    if bufs is None or bufs[0].numel() < v or bufs[2].numel() < v * d:
        bufs = tuple(torch.zeros((n,), dtype=torch.float32, device=dev)
                     for n in (v, v, v * d, v * d))
        _work[dev] = bufs
    return bufs


def sgns_step(syn0, syn1neg, contexts, targets, labels, live, alpha):
    """CPU tensors: :func:`sgns_step_plain`. CUDA tensors: the
    hand-written kernel, or an exception. The kernel takes f32 tables,
    labels and live, int64 indices in [0, V) (an index outside traps on
    the device, which fails the launch and the CUDA context, as PyTorch's
    own device-side index checks do) and D <= 512, and runs on the
    current stream. Its zeroed buffers are shared per device: a lock keeps
    one thread's three launches together on the stream, so threads may
    share a stream, but calls must not run on two streams at once."""
    if syn0.device.type == "cpu":
        return sgns_step_plain(syn0, syn1neg, contexts, targets, labels,
                               live, alpha)
    if syn0.device.type != "cuda":
        raise ValueError(f"sgns_step: unsupported device {syn0.device}")
    v, d = syn0.shape
    b, k1 = targets.shape
    if syn1neg.shape != (v, d):
        raise ValueError(f"sgns_step: syn0 {tuple(syn0.shape)} and syn1neg "
                         f"{tuple(syn1neg.shape)} differ")
    if contexts.shape != (b,) or labels.shape != (b, k1) \
            or live.shape != (b, k1):
        raise ValueError(f"sgns_step: contexts {tuple(contexts.shape)}, "
                         f"labels {tuple(labels.shape)}, live "
                         f"{tuple(live.shape)} for targets {(b, k1)}")
    if not 0 < d <= MAX_DIM:
        raise ValueError(f"sgns_step: D={d}; the kernel takes 1..{MAX_DIM}")
    for name, x, dtype in (("syn0", syn0, torch.float32),
                           ("syn1neg", syn1neg, torch.float32),
                           ("contexts", contexts, torch.int64),
                           ("targets", targets, torch.int64),
                           ("labels", labels, torch.float32),
                           ("live", live, torch.float32)):
        if x.device != syn0.device:
            raise ValueError(f"sgns_step: {name} on {x.device}, syn0 on "
                             f"{syn0.device}")
        if x.dtype != dtype:
            raise ValueError(f"sgns_step: {name} is {x.dtype}, the kernel "
                             f"takes {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"sgns_step: {name} must be contiguous")
    dev = syn0.device
    if isinstance(alpha, torch.Tensor):
        if alpha.numel() != 1 or alpha.dtype != torch.float32 \
                or alpha.device != dev:
            raise ValueError("sgns_step: a tensor alpha must be one f32 "
                             f"value on {dev}")
        alpha_ptr, alpha_val = alpha.data_ptr(), 0.0
    else:
        alpha_ptr, alpha_val = None, float(alpha)
    if b == 0:
        return syn0, syn1neg
    gbuf = torch.empty((b, k1), dtype=torch.float32, device=dev)
    neubuf = torch.empty((b, d), dtype=torch.float32, device=dev)
    lib = build.load("sgns", _SIGNATURE)
    with _work_lock:
        work = _workspace(dev, v, d)
        rc = lib.sgns_step(
            syn0.data_ptr(), syn1neg.data_ptr(), contexts.data_ptr(),
            targets.data_ptr(), labels.data_ptr(), live.data_ptr(),
            alpha_ptr, alpha_val, gbuf.data_ptr(), neubuf.data_ptr(),
            *(x.data_ptr() for x in work), b, k1, d, v, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:  # a failed call may leave its buffers dirty
            _work.pop(dev, None)
    build.check(lib, rc, "sgns_step")
    sgns_step.launches += 1
    return syn0, syn1neg


sgns_step.launches = 0
