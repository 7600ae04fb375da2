"""Recurrent layers (counterpart: ``deeplearning4j_tpu/nn/layers/recurrent.py``
— ``_init_lstm_params``, ``_lstm_step``, ``_scan_lstm``,
``GravesLSTMImpl``, ``GravesBidirectionalLSTMImpl`` :180 and ``GRUImpl``
:215).

Gate math (Graves 2013 with peepholes; gates [i, f, o, g] along the 4H
axis of W, U and b; peepholes p[0], p[1] on c_prev and p[2] on c):
    i = sigmoid(xW_i + hU_i + p0 * c_prev + b_i)
    f = sigmoid(xW_f + hU_f + p1 * c_prev + b_f)
    g = act(xW_g + hU_g + b_g)
    c = f * c_prev + i * g
    o = sigmoid(xW_o + hU_o + p2 * c + b_o)
    h = o * act(c)

The input projection x @ W + b for all timesteps is one matmul outside
the recurrence (its gradient, dW, db and dx, comes from autograd through
that matmul, as XLA's does in the JAX package). Routing, as in the JAX
package (``recurrent.py:97``): a tanh layer with no mask and T >= 8 runs
the whole recurrence through the fused scan (``ops/lstm_scan.py``: the
hand-written kernels K1 and, for the gradient, K2 on the card; their plain
versions on the CPU) — through ``LstmScanFn`` when an input needs a
gradient, through the forward alone otherwise; everything else runs the
per-step loop below under autograd, the counterpart of ``lax.scan``. The
TPU gates of the JAX routing (the measured-win table, the VMEM fit,
``DL4J_TPU_PALLAS``) do not carry over: on the card every routed shape
goes through the kernels, or raises.

The bidirectional LSTM sums a forward and a reversed LSTM, each with its
own params (``fwd``, ``bwd``). Both directions take the per-step loop,
as the JAX layer sends both to ``lax.scan`` (it never asks for the fused
scan); it carries no state across TBPTT windows and ignores
``backprop_window``, as the JAX layer does. The GRU (gates [r, z, n]
along 3H, ``h' = (1 - z) * n + z * h``) runs the per-step loop.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import BaseLayerImpl
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.lstm_scan import LstmScanFn, lstm_scan

KERNEL_MIN_T = 8  # shorter sequences (rnn_time_step streams) loop per step


def _init_lstm_params(conf, gen, n_in, n_out):
    W = init_weights(gen, (n_in, 4 * n_out), conf.weight_init, n_in, n_out,
                     conf.dist)
    U = init_weights(gen, (n_out, 4 * n_out), conf.weight_init, n_out,
                     n_out, conf.dist)
    p = torch.zeros((3, n_out), dtype=torch.float32, device=W.device)
    b = torch.zeros((4 * n_out,), dtype=torch.float32, device=W.device)
    b[n_out:2 * n_out] = conf.forget_gate_bias_init
    return {"W": W, "U": U, "p": p, "b": b}


def _lstm_step(act, params, h_prev, c_prev, xproj_t, mask_t):
    """One step from the precomputed xproj_t = x_t @ W + b. mask_t: [N, 1]
    bool or None; masked rows keep their h and c."""
    z = xproj_t + h_prev @ params["U"]
    zi, zf, zo, zg = z.chunk(4, dim=-1)
    p = params["p"]
    i = torch.sigmoid(zi + p[0] * c_prev)
    f = torch.sigmoid(zf + p[1] * c_prev)
    g = act(zg)
    c = f * c_prev + i * g
    o = torch.sigmoid(zo + p[2] * c)
    h = o * act(c)
    if mask_t is not None:
        h = torch.where(mask_t, h, h_prev)
        c = torch.where(mask_t, c, c_prev)
    return h, c


def _scan_lstm(act, params, x, h0, c0, mask, reverse=False, is_tanh=False,
               backprop_window=None):
    """x [N, T, F] -> (outputs [N, T, H], h_T, c_T); ``reverse`` runs the
    recurrence from the last step to the first (outputs stay in time
    order).

    backprop_window=B < T is the distinct TBPTT back length: the first
    T-B steps run with no gradient (values flow, gradients do not) and
    the last B with it."""
    n, t, _ = x.shape
    if backprop_window is not None and 0 < backprop_window < t \
            and not reverse:
        cut = t - backprop_window
        m_e = mask[:, :cut] if mask is not None else None
        m_l = mask[:, cut:] if mask is not None else None
        with torch.no_grad():
            ys_e, h_m, c_m = _scan_lstm(act, params, x[:, :cut], h0, c0,
                                        m_e, is_tanh=is_tanh)
        ys_l, h_f, c_f = _scan_lstm(act, params, x[:, cut:], h_m, c_m, m_l,
                                    is_tanh=is_tanh)
        return torch.cat([ys_e, ys_l], dim=1), h_f, c_f
    n_out = h0.shape[-1]
    xproj = (x.reshape(n * t, -1) @ params["W"] + params["b"]).reshape(
        n, t, 4 * n_out)
    if is_tanh and mask is None and not reverse and t >= KERNEL_MIN_T:
        args = (xproj, params["U"], params["p"], h0, c0)
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            hs, h_f, c_f = LstmScanFn.apply(*args)
        else:
            hs, h_f, c_f, _ = lstm_scan(*args)
        # the kernels compute in f32; keep the caller's dtype
        return hs.to(x.dtype), h_f.to(x.dtype), c_f.to(x.dtype)
    keep = None if mask is None else (mask != 0)[..., None]  # [N, T, 1]
    h, c = h0, c0
    hs = [None] * t
    for step in (range(t - 1, -1, -1) if reverse else range(t)):
        h, c = _lstm_step(act, params, h, c, xproj[:, step],
                          None if keep is None else keep[:, step])
        hs[step] = h
    return torch.stack(hs, dim=1), h, c


class GravesLSTMImpl(BaseLayerImpl):
    def initialize(self, gen, input_shape):
        t, f = input_shape
        n_in = self.conf.n_in or f
        n_out = self.conf.n_out
        params = _init_lstm_params(self.conf, gen, n_in, n_out)
        dev = params["W"].device
        state = {  # streaming state, sized lazily by rnn_time_step
            "h": torch.zeros((0, n_out), dtype=torch.float32, device=dev),
            "c": torch.zeros((0, n_out), dtype=torch.float32, device=dev),
        }
        return params, state, (t, n_out)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None,
              carry_state=False, backprop_window=None):
        """carry_state=True resumes from state['h'] and state['c'] when
        they match the batch (TBPTT window chaining); the carried state
        enters as data, with no gradient across the window boundary.
        backprop_window truncates the in-window backward pass."""
        x = self._dropout_in(x, train, gen)
        n = x.shape[0]
        if carry_state and state["h"].shape[0] == n:
            h0 = state["h"].detach().to(x.dtype)
            c0 = state["c"].detach().to(x.dtype)
        else:
            h0 = c0 = torch.zeros((n, self.conf.n_out), dtype=x.dtype,
                                  device=x.device)
        ys, h_f, c_f = _scan_lstm(
            self.act, params, x, h0, c0, mask,
            is_tanh=(self.conf.activation or "tanh") == "tanh",
            backprop_window=backprop_window)
        if mask is not None:
            ys = ys * mask.to(ys.dtype)[..., None]
        return ys, {"h": h_f, "c": c_f}

    def step(self, params, state, x_t):
        """One timestep of stateful inference (rnn_time_step). x_t: [N, F]."""
        n = x_t.shape[0]
        n_out = self.conf.n_out

        def carried(v):
            if v.shape[0] == n:
                return v
            return torch.zeros((n, n_out), dtype=x_t.dtype,
                               device=x_t.device)

        xproj = x_t @ params["W"] + params["b"]
        h, c = _lstm_step(self.act, params, carried(state["h"]),
                          carried(state["c"]), xproj, None)
        return h, {"h": h, "c": c}


class GravesBidirectionalLSTMImpl(BaseLayerImpl):
    """A forward and a reversed LSTM over the same input, outputs
    summed."""

    def initialize(self, gen, input_shape):
        t, f = input_shape
        n_in = self.conf.n_in or f
        n_out = self.conf.n_out
        params = {"fwd": _init_lstm_params(self.conf, gen, n_in, n_out),
                  "bwd": _init_lstm_params(self.conf, gen, n_in, n_out)}
        return params, {}, (t, n_out)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None,
              carry_state=False, backprop_window=None):
        # no state across TBPTT windows, and the whole window backprops:
        # the two directions would truncate at opposite ends
        x = self._dropout_in(x, train, gen)
        zeros = torch.zeros((x.shape[0], self.conf.n_out), dtype=x.dtype,
                            device=x.device)
        ys_f, _, _ = _scan_lstm(self.act, params["fwd"], x, zeros, zeros,
                                mask)
        ys_b, _, _ = _scan_lstm(self.act, params["bwd"], x, zeros, zeros,
                                mask, reverse=True)
        ys = ys_f + ys_b
        if mask is not None:
            ys = ys * mask.to(ys.dtype)[..., None]
        return ys, state


class GRUImpl(BaseLayerImpl):
    """r = sigmoid(xW_r + hU_r + b_r), z = sigmoid(xW_z + hU_z + b_z),
    n = act(xW_n + (r * h)U_n + b_n), h' = (1 - z) * n + z * h."""

    def initialize(self, gen, input_shape):
        t, f = input_shape
        n_in = self.conf.n_in or f
        n_out = self.conf.n_out
        W = init_weights(gen, (n_in, 3 * n_out), self.conf.weight_init,
                         n_in, n_out, self.conf.dist)
        U = init_weights(gen, (n_out, 3 * n_out), self.conf.weight_init,
                         n_out, n_out, self.conf.dist)
        b = torch.zeros((3 * n_out,), dtype=torch.float32, device=W.device)
        state = {"h": torch.zeros((0, n_out), dtype=torch.float32,
                                  device=W.device)}
        return {"W": W, "U": U, "b": b}, state, (t, n_out)

    def _step(self, params, h_prev, xproj_t, mask_t):
        zr, zz, zn = xproj_t.chunk(3, dim=-1)
        Ur, Uz, Un = params["U"].chunk(3, dim=-1)
        r = torch.sigmoid(zr + h_prev @ Ur)
        z = torch.sigmoid(zz + h_prev @ Uz)
        n = self.act(zn + (r * h_prev) @ Un)
        h = (1.0 - z) * n + z * h_prev
        if mask_t is not None:
            h = torch.where(mask_t, h, h_prev)
        return h

    def apply(self, params, state, x, *, train=False, gen=None, mask=None,
              carry_state=False, backprop_window=None):
        x = self._dropout_in(x, train, gen)
        n = x.shape[0]
        if carry_state and state["h"].shape[0] == n:
            h0 = state["h"].detach().to(x.dtype)
        else:
            h0 = torch.zeros((n, self.conf.n_out), dtype=x.dtype,
                             device=x.device)
        ys, h_f = self._scan(params, x, h0, mask, backprop_window)
        if mask is not None:
            ys = ys * mask.to(ys.dtype)[..., None]
        return ys, {"h": h_f}

    def _scan(self, params, x, h0, mask, backprop_window=None):
        """[N, T, F] loop; backprop_window splits it as ``_scan_lstm``
        does."""
        n, t, _ = x.shape
        if backprop_window is not None and 0 < backprop_window < t:
            cut = t - backprop_window
            m_e = mask[:, :cut] if mask is not None else None
            m_l = mask[:, cut:] if mask is not None else None
            with torch.no_grad():
                ys_e, h_m = self._scan(params, x[:, :cut], h0, m_e)
            ys_l, h_f = self._scan(params, x[:, cut:], h_m, m_l)
            return torch.cat([ys_e, ys_l], dim=1), h_f
        xproj = (x.reshape(n * t, -1) @ params["W"] + params["b"]).reshape(
            n, t, 3 * self.conf.n_out)
        keep = None if mask is None else (mask != 0)[..., None]
        h, hs = h0, []
        for step in range(t):
            h = self._step(params, h, xproj[:, step],
                           None if keep is None else keep[:, step])
            hs.append(h)
        return torch.stack(hs, dim=1), h

    def step(self, params, state, x_t):
        """One timestep of stateful inference (rnn_time_step)."""
        n = x_t.shape[0]
        h = state["h"]
        if h.shape[0] != n:
            h = torch.zeros((n, self.conf.n_out), dtype=x_t.dtype,
                            device=x_t.device)
        h = self._step(params, h, x_t @ params["W"] + params["b"], None)
        return h, {"h": h}
