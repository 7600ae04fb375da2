"""Character-level LSTM language model (counterpart:
``deeplearning4j_tpu/models/char_rnn.py``).

``char_rnn_conf`` builds the same configuration as the JAX package
(stacked GravesLSTM layers + an RnnOutputLayer softmax over the
characters, truncated BPTT; its JSON is identical). ``CharRnn`` encodes
text, cuts it into one-hot minibatches with next-character labels
(``batches``), trains on them (``fit_text``: one ``fit`` per minibatch,
one train step per TBPTT window) and samples through ``rnn_time_step``,
drawing from ``np.random.default_rng(seed)`` exactly as the JAX package
does. A trained network can also come in through ``net=`` (e.g.
``MultiLayerNetwork.load``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import GravesLSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def char_rnn_conf(
    vocab_size: int,
    lstm_size: int = 200,
    num_layers: int = 2,
    seed: int = 12345,
    learning_rate: float = 0.1,
    updater: str = "rmsprop",
    tbptt_length: int = 50,
):
    b = (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .learning_rate(learning_rate)
        .updater(updater)
        .weight_init("xavier")
        .list()
    )
    n_in = vocab_size
    for i in range(num_layers):
        b = b.layer(i, GravesLSTM(n_in=n_in, n_out=lstm_size,
                                  activation="tanh"))
        n_in = lstm_size
    b = b.layer(
        num_layers,
        RnnOutputLayer(
            n_in=lstm_size, n_out=vocab_size, activation="softmax",
            loss_function="mcxent",
        ),
    )
    return (
        b.backprop_type("truncated_bptt")
        .t_bptt_forward_length(tbptt_length)
        .t_bptt_backward_length(tbptt_length)
        .build()
    )


class CharRnn:
    """Encode text; generate with temperature (and top-k) sampling."""

    def __init__(self, text: Optional[str] = None,
                 chars: Optional[Sequence[str]] = None, *,
                 net: Optional[MultiLayerNetwork] = None, device=None,
                 **conf_kw):
        if chars is None:
            if text is None:
                raise ValueError("need text or an explicit char list")
            chars = sorted(set(text))
        self.chars: List[str] = list(chars)
        self.char_to_ix = {c: i for i, c in enumerate(self.chars)}
        self.vocab_size = len(self.chars)
        if net is None:
            net = MultiLayerNetwork(char_rnn_conf(self.vocab_size, **conf_kw),
                                    device=device)
            net.init(input_shape=(1, self.vocab_size))
        elif net.conf.layers[-1].n_out != self.vocab_size:
            raise ValueError(
                f"net emits {net.conf.layers[-1].n_out} classes for "
                f"{self.vocab_size} characters")
        self.net = net

    def encode(self, text: str) -> np.ndarray:
        return np.array([self.char_to_ix[c] for c in text
                         if c in self.char_to_ix], np.int32)

    def batches(self, text: str, batch: int, seq_len: int):
        """Contiguous [B, T, V] one-hot minibatches with next-character
        labels, as numpy arrays."""
        ids = self.encode(text)
        usable = (len(ids) - 1) // (batch * seq_len) * (batch * seq_len)
        if usable <= 0:
            raise ValueError("text too short for requested batch/seq_len")
        xs = ids[:usable].reshape(batch, -1)
        ys = ids[1:usable + 1].reshape(batch, -1)
        eye = np.eye(self.vocab_size, dtype=np.float32)
        for s in range(xs.shape[1] // seq_len):
            sl = slice(s * seq_len, (s + 1) * seq_len)
            yield eye[xs[:, sl]], eye[ys[:, sl]]

    def fit_text(self, text: str, epochs: int = 1, batch: int = 32,
                 seq_len: int = 100) -> List[float]:
        """Train on ``text``; the loss of each minibatch's last window."""
        losses = []
        for _ in range(epochs):
            for x, y in self.batches(text, batch, seq_len):
                losses.append(float(self.net.fit(x, y)))
        return losses

    def _probs(self, ci: int, eye: np.ndarray) -> np.ndarray:
        y = self.net.rnn_time_step(eye[ci][None, None, :])
        return y.float().cpu().numpy()[0]

    def sample(self, prime: str, length: int = 200, temperature: float = 1.0,
               seed: int = 0, top_k: int = 0) -> str:
        """Stream generation through rnn_time_step; top_k > 0 keeps exactly
        the k most likely characters at each draw."""
        rng = np.random.default_rng(seed)
        self.net.rnn_clear_previous_state()
        eye = np.eye(self.vocab_size, dtype=np.float32)
        known_prime = [c for c in prime if c in self.char_to_ix]
        out = list(known_prime)
        # no known prime chars: start from the uniform distribution
        probs = np.full((1, self.vocab_size), 1.0 / self.vocab_size,
                        np.float32)
        for c in known_prime:
            probs = self._probs(self.char_to_ix[c], eye)
        for _ in range(length):
            p = probs.reshape(-1).astype(np.float64)
            if temperature != 1.0:
                logp = np.log(np.maximum(p, 1e-12)) / temperature
                p = np.exp(logp - logp.max())
            if top_k and top_k < p.size:
                keep = np.argpartition(p, -top_k)[-top_k:]
                mask = np.zeros_like(p)
                mask[keep] = 1.0
                p = p * mask
            p /= p.sum()
            ci = int(rng.choice(self.vocab_size, p=p))
            out.append(self.chars[ci])
            probs = self._probs(ci, eye)
        return "".join(out)
