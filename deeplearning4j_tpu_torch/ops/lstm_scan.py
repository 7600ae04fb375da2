"""Fused peephole-LSTM forward scan, K1 of the port (counterpart:
``deeplearning4j_tpu/ops/pallas_kernels.py`` — ``_lstm_pallas_fwd_raw``
and its kernel body ``_make_lstm_kernel``, reached through
``lstm_pallas_scan``; the plain oracle there is ``_lstm_scan_reference``).

Three things live here:

* :func:`lstm_scan_plain` — the plain PyTorch version: a per-step loop in
  the input's dtype (f32, or f64 in tests). The CPU path and the card's
  equivalence oracle.
* :func:`lstm_scan` — the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor goes to the hand-written kernel
  ``csrc/lstm_scan.cu`` or the wrapper raises. There is no fallback on
  the card.
* a launch counter on each: ``lstm_scan.launches`` counts kernel launches
  only, ``lstm_scan_plain.launches`` counts plain calls.

Both take xproj [N, T, 4H] (``x @ W + b``, gates [i, f, o, g] along the
last axis), U [H, 4H], peepholes p [3, H], h0 and c0 [N, H], and return
``(hs [N, T, H], h_T [N, H], c_T [N, H], cs)`` where cs is the cell
sequence [T, N, H] (time-major, as the TPU kernel emits it for the
backward pass) when ``emit_cs`` is set and None otherwise.

Source note. Replaces the TPU kernel ``_make_lstm_kernel``. On the H100
the recurrence bounds it: the operations bound is 2*N*T*H*4H flops at the
f32 rate (30 us at the char-RNN's N=64, T=100, H=200), but every step
needs every unit's h from the step before, so each of the T steps pays a
grid-wide exchange. The design (see the .cu header): a persistent
cooperative grid in which each CTA owns a few hidden units and keeps their
U columns in shared memory for the whole sequence, c stays with its
owner, h is exchanged through two L2-resident buffers with one grid
barrier per step, and the h @ U product is written out with FMAs. The
kernel computes in f32; inputs of another dtype are cast to f32 first and
the outputs are f32 (the layer casts back, as the JAX layer does).
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


def _lib():
    return build.load("lstm_scan", _SIGNATURE)


def lstm_scan(xproj, u, p, h0, c0, *, emit_cs: bool = False):
    """CPU tensors: :func:`lstm_scan_plain`. CUDA tensors: the hand-written
    kernel (f32 math, f32 outputs), or an exception."""
    if xproj.device.type == "cpu":
        return lstm_scan_plain(xproj, u, p, h0, c0, emit_cs=emit_cs)
    if xproj.device.type != "cuda":
        raise ValueError(f"lstm_scan: unsupported device {xproj.device}")
    if xproj.dim() != 3 or xproj.shape[-1] % 4:
        raise ValueError(f"lstm_scan: xproj {tuple(xproj.shape)} is not "
                         "[N, T, 4H]")
    n, t, four_h = xproj.shape
    h = four_h // 4
    for name, x, shape in (("u", u, (h, four_h)), ("p", p, (3, h)),
                           ("h0", h0, (n, h)), ("c0", c0, (n, h))):
        if tuple(x.shape) != shape:
            raise ValueError(f"lstm_scan: {name} {tuple(x.shape)}, expected "
                             f"{shape} for xproj {tuple(xproj.shape)}")
        if x.device != xproj.device:
            raise ValueError(f"lstm_scan: {name} on {x.device}, xproj on "
                             f"{xproj.device}")
    if n == 0 or t == 0:
        raise ValueError(f"lstm_scan: empty sequence batch "
                         f"{tuple(xproj.shape)}")
    dev = xproj.device
    f32 = torch.float32
    xproj = xproj.to(f32)
    if xproj.stride(-1) != 1:
        xproj = xproj.contiguous()
    u, p, h0, c0 = (x.to(f32).contiguous() for x in (u, p, h0, c0))
    upb = units_per_cta(h, torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    hbuf = torch.empty((2, h, n), dtype=f32, device=dev)
    cbuf = torch.empty((h, n), dtype=f32, device=dev)
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    hs = torch.empty((n, t, h), dtype=f32, device=dev)
    h_t = torch.empty((n, h), dtype=f32, device=dev)
    c_t = torch.empty((n, h), dtype=f32, device=dev)
    cs = torch.empty((t, n, h), dtype=f32, device=dev) if emit_cs else None
    lib = _lib()
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
