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
  only, ``sgns_step_plain.launches`` plain calls. A call made while a
  CUDA graph is being captured launches nothing: it counts in
  ``sgns_step.captured``, and whoever replays the graph adds its
  captured calls to ``launches`` on each replay.
* :func:`hit_lists` — the rows each table's owners update and their hits
  in the order the kernel sums them; :func:`reserve` and
  :func:`workspace_sizes` — the kernel's scratch.

Both update syn0 [V, D] and syn1neg [V, D] in place and return them: the
port's counterpart of the TPU kernel's ``input_output_aliases``. contexts
[B] are syn0 rows; targets [B, K+1] are syn1neg rows, column 0 the center
word (label 1) and the rest negatives (label 0); live [B, K+1] masks dead
negatives and padded pairs; alpha is a float or a 0-d tensor.

Source note. Replaces the TPU kernel ``_sgns_kernel``. Memory bounds it
on the H100: each distinct row a live pair touches (at most B context
rows of syn0 and B*(K+1) rows of syn1neg) is read once and written once,
at most 4*(2*B*D + 2*B*(K+1)*D) bytes, for about 6*B*(K+1)*D flops. The
design (see the .cu header): two launches on the caller's stream. The
first, one warp per pair with D across its lanes, computes the stale
gathers, dots, saturated coefficients and neu1e into scratch and puts
every hit on its row's owner (integer atomics on a [V] head map and the
owner's count, :data:`SLOTS` slots per owner). The second gives each
touched row to its owner, which sums the row's contributions from zero
in batch order (a whole CTA, with a fixed tree over its warps, for a
row of more than :data:`WARP_HITS` hits) and adds the sum once. No float
atomics: two launches give the same bits. :func:`hit_lists` is the
order the owners sum in, in plain PyTorch.

The scratch (:func:`reserve`) is O(B*D + V): per (device, stream), grown
when a larger batch or table comes, never while a CUDA graph is being
captured. A capture needs it allocated first, on the capture stream.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch.ops import build

MAX_EXP = 6.0  # word2vec.c's sigmoid table range; dots past it saturate
MAX_DIM = 512  # the kernel holds D / 32 elements per lane, at most 16
SLOTS = 64     # hits a row's owner keeps by slot (csrc/sgns.cu kSlots)
WARP_HITS = 16  # rows of up to this many hits: summed by the owner's warp
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = {"sgns_step": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_float,
                            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P],
              "sgns_prepare": [_I]}
# the scratch in the kernel's argument order
_SCRATCH = ("l1", "neu1e", "coef", "hit_row", "head0", "head1", "count",
            "slots", "hot", "hot_count")

_work_lock = threading.Lock()
# per (device, stream handle): the kernel's scratch, by _SCRATCH name
_work: Dict[Tuple[torch.device, int], Dict[str, torch.Tensor]] = {}


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


def workspace_sizes(v: int, d: int, b: int, k1: int
                    ) -> Dict[str, Tuple[int, torch.dtype]]:
    """Elements and dtype of each scratch tensor of a call at (V, D, B,
    K+1), with H = B*(K+2) hits at most: the stale l1 and neu1e of every
    pair [B*D], g*live [B*(K+1)], each hit's row [H], a head map per table
    [V] (-1 between calls), each owner's count [H] (0 between calls),
    slots [H*SLOTS], and the list of rows of more than WARP_HITS hits
    with its length and a count of finished CTAs (0 between calls). No
    [V, D] buffer."""
    f32, i32 = torch.float32, torch.int32
    h = b * (k1 + 1)
    return {"l1": (b * d, f32), "neu1e": (b * d, f32), "coef": (b * k1, f32),
            "hit_row": (h, i32), "head0": (v, i32), "head1": (v, i32),
            "count": (h, i32), "slots": (h * SLOTS, i32),
            "hot": (h // (WARP_HITS + 1) + 1, i32), "hot_count": (2, i32)}


def _workspace(dev: torch.device, stream, v: int, d: int, b: int, k1: int):
    """The scratch of calls on ``stream`` (allocated on it, or grown when
    a larger table or batch comes). Raises while a graph is being
    captured: the capture's kernels would keep pointers into memory the
    graph's pool owns. The caller holds ``_work_lock``."""
    key = (dev, stream.cuda_stream)
    need = workspace_sizes(v, d, b, k1)
    bufs = _work.get(key)
    if bufs is not None and all(bufs[n].numel() >= need[n][0] for n in need):
        return bufs
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "sgns_step: no scratch of this size for the capture stream; call "
            "ops.sgns.reserve on it before capturing a CUDA graph")
    with torch.cuda.stream(stream):
        bufs = {}
        for n, (size, dtype) in need.items():
            old = _work.get(key, {}).get(n)
            size = max(size, 0 if old is None else old.numel())
            fill = -1 if n.startswith("head") else 0
            bufs[n] = torch.full((size,), fill, dtype=dtype, device=dev)
    _work[key] = bufs
    return bufs


def reserve(device, v: int, d: int, b: int, k1: int, stream=None) -> None:
    """Ready calls at (V, D, B, K+1) on ``stream`` (the device's current
    stream by default) for a CUDA graph's capture: their scratch allocated
    there now, the kernel built and its functions loaded on the device
    (lazy module loading would load them at their first launch). Calls on
    that stream then allocate and load nothing."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    lib = build.load("sgns", _SIGNATURE)
    build.check(lib, lib.sgns_prepare(dev.index), "sgns_prepare")
    with _work_lock:
        _workspace(dev, stream or torch.cuda.current_stream(dev), v, d, b, k1)


def hit_lists(contexts, targets, live):
    """For (syn0, syn1neg): the rows a batch updates and each row's hits in
    the order K3 sums them, as ``(rows, starts, hits)``: ``rows`` [R]
    ascending, ``hits`` the hit indices of ``rows[r]`` at
    ``hits[starts[r]:starts[r + 1]]``, ascending (batch order). Hit
    indices as the kernel numbers them: b*(K+1) + k for a target entry with
    live != 0, B*(K+1) + b for a context whose pair has a live entry. A
    row's owner warp sums up to WARP_HITS hits, a CTA more."""
    b, k1 = targets.shape
    n_hits = b * (k1 + 1)
    flat = live.reshape(-1) != 0
    t_hits = torch.nonzero(flat).squeeze(1)
    c_hits = torch.nonzero(live.sum(dim=1) > 0).squeeze(1)
    out = []
    for rows, hits in ((contexts[c_hits], c_hits + b * k1),
                       (targets.reshape(-1)[t_hits], t_hits)):
        order = torch.argsort(rows * n_hits + hits)
        rows, hits = rows[order], hits[order]
        uniq, counts = torch.unique_consecutive(rows, return_counts=True)
        starts = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        out.append((uniq, starts, hits))
    return tuple(out)


def sgns_step(syn0, syn1neg, contexts, targets, labels, live, alpha):
    """CPU tensors: :func:`sgns_step_plain`. CUDA tensors: the
    hand-written kernel (two launches on the current stream), or an
    exception. The kernel takes f32 tables, labels and live, int64 indices
    in [0, V) (an index outside traps on the device, which fails the
    launch and the CUDA context, as PyTorch's own device-side index checks
    do), D <= 512, and V and B*(K+2) below 2^31. It allocates nothing once
    its stream's scratch is big enough (:func:`reserve`), reads a tensor
    alpha on the device and never reads back to the host, so a call can
    be captured in a CUDA graph. A lock keeps one thread's two launches
    together on the stream; calls on different streams have their own
    scratch."""
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
    if v >= 2**31 or b * (k1 + 1) >= 2**31:
        raise ValueError(f"sgns_step: V={v}, B*(K+2)={b * (k1 + 1)}; the "
                         "kernel indexes rows and hits with 32-bit ints")
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
    # 16-byte row loads where every row starts on 16 bytes
    vec = int(d % 4 == 0 and syn0.data_ptr() % 16 == 0
              and syn1neg.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev)
    capturing = torch.cuda.is_current_stream_capturing()
    lib = build.load("sgns", _SIGNATURE)
    with _work_lock:
        work = _workspace(dev, stream, v, d, b, k1)
        rc = lib.sgns_step(
            syn0.data_ptr(), syn1neg.data_ptr(), contexts.data_ptr(),
            targets.data_ptr(), labels.data_ptr(), live.data_ptr(),
            alpha_ptr, alpha_val, *(work[n].data_ptr() for n in _SCRATCH),
            b, k1, d, v, vec, dev.index, stream.cuda_stream)
        if rc != 0:  # a failed call may leave its maps dirty
            _work.pop((dev, stream.cuda_stream), None)
    build.check(lib, rc, "sgns_step")
    if capturing:
        sgns_step.captured += 1
    else:
        sgns_step.launches += 1
    return syn0, syn1neg


sgns_step.launches = 0
sgns_step.captured = 0
