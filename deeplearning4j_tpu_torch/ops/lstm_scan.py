"""Fused peephole-LSTM scan, forward (K1) and backward (K2) of the port
(counterpart: ``deeplearning4j_tpu/ops/pallas_kernels.py`` —
``_lstm_pallas_fwd_raw`` with its body ``_make_lstm_kernel``,
``_lstm_pallas_bwd_raw`` with its body ``_lstm_bwd_kernel``, and the
``custom_vjp`` ``lstm_pallas_scan`` that joins them; the plain oracle there
is ``_lstm_scan_reference``).

What lives here:

* :func:`lstm_scan_plain` and :func:`lstm_scan_bwd_plain` — the plain
  PyTorch versions: per-step loops in the input's dtype (f32, or f64 in
  tests), forward and reverse. The CPU path and the card's oracles.
* :func:`lstm_scan` and :func:`lstm_scan_bwd` — the wrappers. A CPU
  tensor goes to the plain version; a CUDA tensor goes to the hand-written
  kernel (``csrc/lstm_scan.cu``, ``csrc/lstm_scan_bwd.cu``) or the wrapper
  raises. There is no fallback on the card.
* a launch counter on each: ``lstm_scan.launches`` and
  ``lstm_scan_bwd.launches`` count kernel launches only, the ``_plain``
  counters count plain calls.
* :func:`plan_scan` — the kernels' layout for a shape: batch rows per
  block, CTAs per cluster, hidden units per CTA, U rows kept in shared
  memory, shared-memory bytes (a plain function, tested on the CPU).
* :class:`LstmScanFn` — the autograd function (the ``custom_vjp``): its
  forward runs :func:`lstm_scan` with the cell sequence, its backward
  :func:`lstm_scan_bwd`.

The forward takes xproj [N, T, 4H] (``x @ W + b``, gates [i, f, o, g]
along the last axis), U [H, 4H], peepholes p [3, H], h0 and c0 [N, H], and
returns ``(hs [N, T, H], h_T [N, H], c_T [N, H], cs)`` where cs is the
cell sequence [T, N, H] (time-major, as the TPU kernel emits it for the
backward pass) when ``emit_cs`` is set and None otherwise. The backward
takes the forward's inputs, cs, hs and the cotangents of hs, h_T and c_T,
and returns ``(dxproj, dU, dp, dh0, dc0)``.

Source note. Replaces the TPU kernels ``_make_lstm_kernel`` and
``_lstm_bwd_kernel``. On the H100 the recurrence bounds both: the
operations bound is 2*N*T*H*4H flops at the 3xTF32 rate for the forward
(12.4 us at the char-RNN's N=64, T=100, H=200) and three times that for
the backward, but every step of a batch row needs every unit's h
(forward) or dz (backward) of that row from the step before, so the time
is T times the latency of one step. The design (see the .cu headers):
one thread-block cluster per block of batch rows, its CTAs splitting the
hidden units, each CTA keeping its slice of U in shared memory for the
whole sequence; h (forward) or the partial dz U^T (backward) crosses
between the CTAs through distributed shared memory, stores counted on
the receiving CTA's mbarrier, with no barrier across the cluster or the
grid per step; the backward's gate recompute and dU run before and after
its sweep as products over the whole card, on the tensor cores at f32
accuracy (3xTF32); the per-step products are FMAs; every sum runs in a
fixed order (two launches give the same bits). The kernels compute
in f32; inputs of another dtype are cast to f32 first and the outputs are
f32 (the callers cast back, as the JAX layer does).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from deeplearning4j_tpu_torch.ops import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURE = {"lstm_scan_fwd": [_P, _L, _L] + [_P] * 8 + [_I] * 10 + [_P],
              "lstm_scan_fwd_clusters": [_I] * 4}
_BWD_SIGNATURE = {"lstm_scan_bwd": [_P, _L, _L] + [_P] * 16 + [_I] * 10
                  + [_P],
                  "lstm_scan_bwd_clusters": [_I] * 4}

THREADS = 256               # per CTA (csrc/lstm_cluster.cuh kThreads)
MAX_OWNED = 2               # (row, unit) items per thread (kMaxOwned)
ROW_BLOCKS = (1, 2, 4, 8, 16)  # batch rows per cluster: the kernels' templates
CLUSTER_SIZES = (16, 8)     # CTAs per cluster, in the order tried
SMEM_OPTIN_H100 = 232_448   # dynamic shared memory a block may use, H100
DU_TILE = 64                # output tile of K2's dU product (kTile)


def lstm_scan_plain(xproj, u, p, h0, c0, *, emit_cs: bool = False):
    """The same function as the kernel, one step at a time in the input's
    dtype: z = xproj_t + h @ U; i, f = sigmoid(z + p * c_prev); g = tanh;
    c = f c_prev + i g; o = sigmoid(z_o + p2 * c); h = o tanh(c)."""
    lstm_scan_plain.launches += 1
    t_len = xproj.shape[1]
    h, c = h0, c0
    hs, cs = [], []
    for t in range(t_len):
        z = xproj[:, t] + h @ u
        zi, zf, zo, zg = z.chunk(4, dim=-1)
        i = torch.sigmoid(zi + p[0] * c)
        f = torch.sigmoid(zf + p[1] * c)
        g = torch.tanh(zg)
        c = f * c + i * g
        o = torch.sigmoid(zo + p[2] * c)
        h = o * torch.tanh(c)
        hs.append(h)
        if emit_cs:
            cs.append(c)
    return (torch.stack(hs, dim=1), h, c,
            torch.stack(cs, dim=0) if emit_cs else None)


lstm_scan_plain.launches = 0


@dataclass(frozen=True)
class ScanPlan:
    """One launch's layout (the .cu files recompute ``smem`` from the rest
    and refuse a plan whose count differs)."""

    rows: int       # batch rows per block; one cluster per block
    cluster: int    # CTAs per cluster; they split the hidden units
    units: int      # hidden units per CTA (the last CTAs may hold fewer)
    ksplit: int     # K1: threads sharing one unit's k range (K2: 1)
    k_smem: int     # rows of the CTA's column slice of U in shared memory
    smem: int       # dynamic shared-memory bytes per CTA
    blocks: int     # row blocks, i.e. clusters in the grid
    du_splits: int  # K2: row ranges of the dU product (K1: 1)


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def _layout(n: int, t: int, h: int, rows: int, cluster: int,
            backward: bool, smem_limit: int, sms: int) -> Optional[ScanPlan]:
    """The layout at one (rows, cluster), or None where the kernel cannot
    take it: a CTA's units must fit its threads, each thread owns at most
    MAX_OWNED (row, unit) items, and the fixed tiles must fit the shared
    memory; U's column slice (16 bytes per k row and unit, the units
    padded to an odd count against bank conflicts) takes what is left, up
    to all H rows."""
    units = -(-h // cluster)
    if units > THREADS or rows * units > MAX_OWNED * THREADS:
        return None
    ksplit, du_splits = 1, 1
    if backward:
        # two mbarriers; dz [units][R] float4; partial dh_carry
        # [2][C][units][R]
        fixed = 4 * (4 + 4 * units * rows
                     + 2 * _round4(cluster * units * rows))
        tiles = -(-h // DU_TILE) * -(-4 * h // DU_TILE)
        du_splits = max(1, min(n * t // 256, 2 * sms // tiles))
    else:
        # k shares: a power of two, each of at least 8 k rows
        while units * ksplit * 2 <= THREADS and ksplit * 2 <= max(1, h // 8):
            ksplit *= 2
        # two mbarriers; h [2][H][ldh] (rows padded by 4 from R = 8); k
        # shares [ksplit][R*units + 1] float4; h_t [units][R]
        ldh = rows + 4 if rows >= 8 else rows
        fixed = 4 * (4 + 2 * _round4(h * ldh)
                     + 4 * ksplit * (units * rows + 1)
                     + _round4(units * rows))
    if fixed > smem_limit:
        return None
    row = 16 * (units | 1)
    k_smem = min(h, (smem_limit - fixed) // row)
    return ScanPlan(rows, cluster, units, ksplit, k_smem,
                    fixed + row * k_smem, -(-n // rows), du_splits)


def plan_scan(n: int, t: int, h: int, *, backward: bool, sms: int,
              smem_limit: int,
              capacity: Callable[[int, int, int], int]) -> ScanPlan:
    """The layout of K1 (``backward=False``) or K2's sweep at (N, T, H).
    ``capacity(rows, cluster, smem)`` is how many clusters of that kernel
    the card runs at once (``cudaOccupancyMaxActiveClusters``). Tries 16
    CTAs per cluster, then 8; at each, the fewest rows per block that put
    every row block on the card at once (N=1: one cluster), else the most
    the layout allows. Raises ValueError, with the reason, where no layout
    takes the shape: the wrapper never falls back to the plain version."""
    if min(n, t, h) <= 0:
        raise ValueError(f"lstm_scan: empty shape N={n} T={t} H={h}")
    why = []
    for cluster in CLUSTER_SIZES:
        best, fitted = None, False
        for rows in ROW_BLOCKS:
            lay = _layout(n, t, h, rows, cluster, backward, smem_limit, sms)
            if lay is None:
                continue
            fitted = True
            cap = capacity(rows, cluster, lay.smem)
            if cap >= 1:
                best = lay
                if lay.blocks <= cap:
                    break
        if best is not None:
            return best
        why.append(f"clusters of {cluster} CTAs do not schedule" if fitted
                   else f"{-(-h // cluster)} units per CTA at {cluster} CTAs "
                   "per cluster do not fit a CTA")
    raise ValueError(f"lstm_scan: no cluster layout for N={n} T={t} H={h}: "
                     + "; ".join(why))


_capacity: Dict[tuple, int] = {}
_plans: Dict[tuple, ScanPlan] = {}


def _card_plan(lib, query: str, n: int, t: int, h: int, backward: bool,
               dev: torch.device) -> ScanPlan:
    """:func:`plan_scan` on this card, the cluster capacities asked of
    ``cudaOccupancyMaxActiveClusters`` once each (a query that fails
    raises with its CUDA error)."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    # K1's layout does not depend on T (K2's dU ranges do): one entry per
    # batch size and width, however many sequence lengths a server sees
    key = (query, index, n, t if backward else None, h)
    if key in _plans:
        return _plans[key]
    props = torch.cuda.get_device_properties(index)

    def capacity(rows, cluster, smem):
        ck = (query, index, rows, cluster, smem)
        if ck not in _capacity:
            got = getattr(lib, query)(rows, cluster, smem, index)
            if got < 0:
                build.check(lib, -got, f"{query}({rows} rows, cluster "
                            f"{cluster}, {smem} bytes)")
            _capacity[ck] = got
        return _capacity[ck]

    plan = plan_scan(n, t, h, backward=backward,
                     sms=props.multi_processor_count,
                     smem_limit=getattr(props, "shared_memory_per_block_optin",
                                        SMEM_OPTIN_H100),
                     capacity=capacity)
    _plans[key] = plan
    return plan


def _card_inputs(what, xproj, u, p, h0, c0, extra=()):
    """Check a card call's shapes against xproj [N, T, 4H] (``extra``: more
    ``(name, tensor, shape_of(N, T, H))``) and cast every tensor to f32:
    xproj keeps its strides when its last axis is unit-stride, the rest
    are made contiguous. Returns the f32 tensors in order, then
    (N, T, H)."""
    if xproj.dim() != 3 or xproj.shape[-1] % 4:
        raise ValueError(f"{what}: xproj {tuple(xproj.shape)} is not "
                         "[N, T, 4H]")
    n, t, four_h = xproj.shape
    h = four_h // 4
    named = [("u", u, (h, four_h)), ("p", p, (3, h)), ("h0", h0, (n, h)),
             ("c0", c0, (n, h))]
    named += [(k, x, shape_of(n, t, h)) for k, x, shape_of in extra]
    for name, x, shape in named:
        if tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} {tuple(x.shape)}, expected "
                             f"{shape} for xproj {tuple(xproj.shape)}")
        if x.device != xproj.device:
            raise ValueError(f"{what}: {name} on {x.device}, xproj on "
                             f"{xproj.device}")
    if n == 0 or t == 0:
        raise ValueError(f"{what}: empty sequence batch "
                         f"{tuple(xproj.shape)}")
    f32 = torch.float32
    xproj = xproj.to(f32)
    if xproj.stride(-1) != 1:
        xproj = xproj.contiguous()
    rest = [x.to(f32).contiguous() for _, x, _ in named]
    return [xproj] + rest + [n, t, h]


def lstm_scan(xproj, u, p, h0, c0, *, emit_cs: bool = False):
    """CPU tensors: :func:`lstm_scan_plain`. CUDA tensors: the hand-written
    kernel (f32 math, f32 outputs), or an exception."""
    if xproj.device.type == "cpu":
        return lstm_scan_plain(xproj, u, p, h0, c0, emit_cs=emit_cs)
    if xproj.device.type != "cuda":
        raise ValueError(f"lstm_scan: unsupported device {xproj.device}")
    xproj, u, p, h0, c0, n, t, h = _card_inputs(
        "lstm_scan", xproj, u, p, h0, c0)
    dev = xproj.device
    f32 = torch.float32
    lib = build.load("lstm_scan", _SIGNATURE)
    pl = _card_plan(lib, "lstm_scan_fwd_clusters", n, t, h, False, dev)
    hs = torch.empty((n, t, h), dtype=f32, device=dev)
    h_t = torch.empty((n, h), dtype=f32, device=dev)
    c_t = torch.empty((n, h), dtype=f32, device=dev)
    cs = torch.empty((t, n, h), dtype=f32, device=dev) if emit_cs else None
    rc = lib.lstm_scan_fwd(
        xproj.data_ptr(), xproj.stride(0), xproj.stride(1), u.data_ptr(),
        p.data_ptr(), h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
        h_t.data_ptr(), c_t.data_ptr(),
        cs.data_ptr() if cs is not None else None, n, t, h, pl.rows,
        pl.cluster, pl.units, pl.ksplit, pl.k_smem, pl.smem, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "lstm_scan")
    lstm_scan.launches += 1
    return hs, h_t, c_t, cs


lstm_scan.launches = 0


def lstm_scan_bwd_plain(xproj, u, p, h0, c0, cs, hs, dhs, dh_t, dc_t):
    """The same function as the backward kernel, one step at a time in the
    input's dtype, from t = T-1 down to 0: the gates are recomputed from
    xproj and h_prev (hs[t-1], h0 at t = 0), c_prev and c come from cs
    (c0 at t = 0); dh = dhs_t + dh_carry, dz = [dzi, dzf, dzo, dzg],
    dU += h_prev^T dz, dp += the peepholes' sums over rows,
    dh_carry = dz U^T, dc_carry = dc f + dzi p_i + dzf p_f."""
    lstm_scan_bwd_plain.launches += 1
    t_len = xproj.shape[1]
    dh_c, dc_c = dh_t, dc_t
    du = torch.zeros_like(u)
    dp = torch.zeros_like(p)
    dxs = [None] * t_len
    for t in reversed(range(t_len)):
        h_prev = h0 if t == 0 else hs[:, t - 1]
        c_prev = c0 if t == 0 else cs[t - 1]
        c = cs[t]
        zi, zf, zo, zg = (xproj[:, t] + h_prev @ u).chunk(4, dim=-1)
        i = torch.sigmoid(zi + p[0] * c_prev)
        f = torch.sigmoid(zf + p[1] * c_prev)
        o = torch.sigmoid(zo + p[2] * c)
        g = torch.tanh(zg)
        tc = torch.tanh(c)
        dh = dhs[:, t] + dh_c
        dzo = dh * tc * o * (1.0 - o)
        dc = dh * o * (1.0 - tc * tc) + dc_c + dzo * p[2]
        dzi = dc * g * i * (1.0 - i)
        dzg = dc * i * (1.0 - g * g)
        dzf = dc * c_prev * f * (1.0 - f)
        dz = torch.cat([dzi, dzf, dzo, dzg], dim=-1)
        dxs[t] = dz
        du = du + h_prev.T @ dz
        dp = dp + torch.stack([(dzi * c_prev).sum(0), (dzf * c_prev).sum(0),
                               (dzo * c).sum(0)])
        dh_c = dz @ u.T
        dc_c = dc * f + dzi * p[0] + dzf * p[1]
    return torch.stack(dxs, dim=1), du, dp, dh_c, dc_c


lstm_scan_bwd_plain.launches = 0


def lstm_scan_bwd(xproj, u, p, h0, c0, cs, hs, dhs, dh_t, dc_t):
    """CPU tensors: :func:`lstm_scan_bwd_plain`. CUDA tensors: the
    hand-written reverse-time kernel (f32 math, f32 outputs), or an
    exception. Returns ``(dxproj [N, T, 4H], dU [H, 4H], dp [3, H],
    dh0 [N, H], dc0 [N, H])``; two launches on the same inputs give the
    same bits (no atomics)."""
    if xproj.device.type == "cpu":
        return lstm_scan_bwd_plain(xproj, u, p, h0, c0, cs, hs, dhs, dh_t,
                                   dc_t)
    if xproj.device.type != "cuda":
        raise ValueError(f"lstm_scan_bwd: unsupported device {xproj.device}")
    (xproj, u, p, h0, c0, cs, hs, dhs, dh_t, dc_t, n, t,
     h) = _card_inputs("lstm_scan_bwd", xproj, u, p, h0, c0, extra=(
         ("cs", cs, lambda n, t, h: (t, n, h)),
         ("hs", hs, lambda n, t, h: (n, t, h)),
         ("dhs", dhs, lambda n, t, h: (n, t, h)),
         ("dh_t", dh_t, lambda n, t, h: (n, h)),
         ("dc_t", dc_t, lambda n, t, h: (n, h))))
    dev = xproj.device
    f32 = torch.float32
    dxproj = torch.empty((n, t, 4 * h), dtype=f32, device=dev)
    du = torch.empty((h, 4 * h), dtype=f32, device=dev)
    dp = torch.empty((3, h), dtype=f32, device=dev)
    dh0 = torch.empty((n, h), dtype=f32, device=dev)
    dc0 = torch.empty((n, h), dtype=f32, device=dev)
    lib = build.load("lstm_scan_bwd", _BWD_SIGNATURE)
    pl = _card_plan(lib, "lstm_scan_bwd_clusters", n, t, h, True, dev)
    # the dU product's per-range slices, and each row's dp sums
    ws = (torch.empty((pl.du_splits, h, 4 * h), dtype=f32, device=dev)
          if pl.du_splits > 1 else None)
    dpp = torch.empty((n, 3, h), dtype=f32, device=dev)
    rc = lib.lstm_scan_bwd(
        xproj.data_ptr(), xproj.stride(0), xproj.stride(1),
        *(x.data_ptr() for x in (u, p, h0, c0, cs, hs, dhs, dh_t, dc_t,
                                 dxproj, du, dp, dh0, dc0)),
        ws.data_ptr() if ws is not None else None, dpp.data_ptr(),
        n, t, h, pl.rows, pl.cluster, pl.units, pl.k_smem, pl.smem,
        pl.du_splits, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "lstm_scan_bwd")
    lstm_scan_bwd.launches += 1
    return dxproj, du, dp, dh0, dc0


lstm_scan_bwd.launches = 0


class LstmScanFn(torch.autograd.Function):
    """The scan with its hand-written backward (the ``custom_vjp``
    ``lstm_pallas_scan``): ``LstmScanFn.apply(xproj, U, p, h0, c0)`` gives
    ``(hs, h_T, c_T)``. The forward runs :func:`lstm_scan` with the cell
    sequence and saves what the backward reads; the backward runs
    :func:`lstm_scan_bwd` (an output with no cotangent arrives as zeros)
    and returns the gradients in each input's dtype."""

    @staticmethod
    def forward(ctx, xproj, u, p, h0, c0):
        hs, h_t, c_t, cs = lstm_scan(xproj, u, p, h0, c0, emit_cs=True)
        ctx.save_for_backward(xproj, u, p, h0, c0, cs, hs)
        return hs, h_t, c_t

    @staticmethod
    def backward(ctx, dhs, dh_t, dc_t):
        xproj, u, p, h0, c0, cs, hs = ctx.saved_tensors
        grads = lstm_scan_bwd(xproj, u, p, h0, c0, cs, hs, dhs, dh_t, dc_t)
        return tuple(g.to(x.dtype)
                     for g, x in zip(grads, (xproj, u, p, h0, c0)))
