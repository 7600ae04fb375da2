"""Multi-head self-attention layer (counterpart:
``deeplearning4j_tpu/nn/layers/attention.py`` ``MultiHeadAttentionImpl``,
:23-83).

Functional attention over [N, T, F] activations, with the JAX package's
parameter names (``Wq``, ``Wk``, ``Wv`` [F, proj], ``Wo`` [proj, n_out],
``b`` [n_out]) so its zips load as they are. ``apply`` runs
``parallel/sequence_parallel.mha_apply`` -> ``ops/flash_attention
.attention_auto``: a feature mask from the container is the key mask (K5
on the card), no mask runs K4; the output is then activated and masked.
``step`` is ``rnn_time_step`` with a KV cache, through the plain
``multi_head_attention``.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import BaseLayerImpl
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    mha_apply,
    multi_head_attention,
)

_PROJ = ("Wq", "Wk", "Wv", "Wo")


class MultiHeadAttentionImpl(BaseLayerImpl):
    # the stream state is a KV cache that grows by one position per step:
    # rnn_clear_previous_state empties it (MultiLayerNetwork)
    grows_state = True

    def initialize(self, gen, input_shape):
        t, f = input_shape
        conf = self.conf
        n_in = conf.n_in or f
        n_out = conf.n_out or n_in
        proj = conf.num_heads * (n_out // conf.num_heads)

        def w(shape):
            return init_weights(gen, shape, conf.weight_init or "xavier",
                                shape[0], shape[1], conf.dist)

        params = {"Wq": w((n_in, proj)), "Wk": w((n_in, proj)),
                  "Wv": w((n_in, proj)), "Wo": w((proj, n_out))}
        params["b"] = torch.zeros((n_out,), dtype=torch.float32,
                                  device=params["Wq"].device)
        return params, {}, (t, n_out)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._dropout_in(x, train, gen)
        y = mha_apply({k: params[k] for k in _PROJ}, x, self.conf.num_heads,
                      causal=self.conf.causal, key_mask=mask) + params["b"]
        y = self.act(y)
        if mask is not None:
            y = y * mask.to(y.dtype)[..., None]
        return y, state

    def step(self, params, state, x_t):
        """One streaming step with a KV cache (the attention analogue of
        carried LSTM state). x_t [N, F]; every cached position is
        visible."""
        n = x_t.shape[0]
        heads = self.conf.num_heads
        proj = params["Wq"].shape[1]

        def split(w):
            return (x_t @ w).reshape(n, 1, heads, proj // heads)

        q, k_new, v_new = (split(params[k]) for k in ("Wq", "Wk", "Wv"))
        k_cache = state.get("k_cache")
        if k_cache is None or k_cache.shape[0] != n:
            k, v = k_new, v_new
        else:
            k = torch.cat([k_cache, k_new], dim=1)
            v = torch.cat([state["v_cache"], v_new], dim=1)
        att = multi_head_attention(q, k, v, causal=False)
        y = att.reshape(n, proj) @ params["Wo"] + params["b"]
        return self.act(y), {"k_cache": k, "v_cache": v}
