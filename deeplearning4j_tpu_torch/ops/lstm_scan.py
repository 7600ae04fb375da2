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
operations bound is 2*N*T*H*4H flops at the f32 rate for the forward (30
us at the char-RNN's N=64, T=100, H=200) and three times that for the
backward, but every step needs every unit's h (forward) or dz (backward)
from the step before, so each of the T steps pays a grid-wide exchange.
The design (see the .cu headers): a persistent cooperative grid in which
each CTA owns a few hidden units and keeps their slice of U in shared
memory for the whole sequence, the cell state (and its cotangent) stays
with its owner, h or dz is exchanged through two L2-resident buffers with
one grid barrier per step, and the products are written out with FMAs.
The kernels compute in f32; inputs of another dtype are cast to f32 first
and the outputs are f32 (the callers cast back, as the JAX layer does).
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import build

MAX_UNITS_PER_CTA = 8
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURE = {"lstm_scan_fwd": [_P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, _P, _I, _I, _I, _I, _I, _P]}
_BWD_SIGNATURE = {"lstm_scan_bwd": [_P, _L, _L] + [_P] * 18
                  + [_I, _I, _I, _I, _I, _P]}


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


def units_per_cta(h: int, sms: int) -> int:
    """Hidden units each CTA owns: the smallest power of two that puts the
    grid (ceil(H / upb) CTAs) on at most ``sms`` SMs, so every CTA of the
    cooperative grid is resident. Raises past MAX_UNITS_PER_CTA."""
    upb = 1
    while -(-h // upb) > sms:
        upb *= 2
        if upb > MAX_UNITS_PER_CTA:
            raise ValueError(
                f"lstm_scan: H={h} needs more than {MAX_UNITS_PER_CTA} "
                f"units per CTA on {sms} SMs; the kernel does not take it")
    return upb


def _card_inputs(what, xproj, u, p, h0, c0, extra=()):
    """Check a card call's shapes against xproj [N, T, 4H] (``extra``: more
    ``(name, tensor, shape_of(N, T, H))``) and cast every tensor to f32:
    xproj keeps its strides when its last axis is unit-stride, the rest
    are made contiguous. Returns the f32 tensors in order, then
    (N, T, H, units per CTA)."""
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
    upb = units_per_cta(h, torch.cuda.get_device_properties(xproj.device)
                        .multi_processor_count)
    return [xproj] + rest + [n, t, h, upb]


def lstm_scan(xproj, u, p, h0, c0, *, emit_cs: bool = False):
    """CPU tensors: :func:`lstm_scan_plain`. CUDA tensors: the hand-written
    kernel (f32 math, f32 outputs), or an exception."""
    if xproj.device.type == "cpu":
        return lstm_scan_plain(xproj, u, p, h0, c0, emit_cs=emit_cs)
    if xproj.device.type != "cuda":
        raise ValueError(f"lstm_scan: unsupported device {xproj.device}")
    xproj, u, p, h0, c0, n, t, h, upb = _card_inputs(
        "lstm_scan", xproj, u, p, h0, c0)
    dev = xproj.device
    f32 = torch.float32
    hbuf = torch.empty((2, h, n), dtype=f32, device=dev)
    cbuf = torch.empty((h, n), dtype=f32, device=dev)
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    hs = torch.empty((n, t, h), dtype=f32, device=dev)
    h_t = torch.empty((n, h), dtype=f32, device=dev)
    c_t = torch.empty((n, h), dtype=f32, device=dev)
    cs = torch.empty((t, n, h), dtype=f32, device=dev) if emit_cs else None
    lib = build.load("lstm_scan", _SIGNATURE)
    rc = lib.lstm_scan_fwd(
        xproj.data_ptr(), xproj.stride(0), xproj.stride(1), u.data_ptr(),
        p.data_ptr(), h0.data_ptr(), c0.data_ptr(), hbuf.data_ptr(),
        cbuf.data_ptr(), hs.data_ptr(), h_t.data_ptr(), c_t.data_ptr(),
        cs.data_ptr() if cs is not None else None, counter.data_ptr(),
        n, t, h, upb, dev.index, torch.cuda.current_stream(dev).cuda_stream)
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
    (xproj, u, p, h0, c0, cs, hs, dhs, dh_t, dc_t, n, t, h,
     upb) = _card_inputs("lstm_scan_bwd", xproj, u, p, h0, c0, extra=(
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
    dzbuf = torch.empty((2, h, n, 4), dtype=f32, device=dev)
    dhc = torch.empty((h, n), dtype=f32, device=dev)
    dcc = torch.empty((h, n), dtype=f32, device=dev)
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = build.load("lstm_scan_bwd", _BWD_SIGNATURE)
    rc = lib.lstm_scan_bwd(
        xproj.data_ptr(), xproj.stride(0), xproj.stride(1),
        *(x.data_ptr() for x in (u, p, h0, c0, cs, hs, dhs, dh_t, dc_t,
                                 dxproj, du, dp, dh0, dc0, dzbuf, dhc, dcc,
                                 counter)),
        n, t, h, upb, dev.index, torch.cuda.current_stream(dev).cuda_stream)
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
