"""Word-vector files of the port (counterpart:
``deeplearning4j_tpu/nlp/serializer.py`` — ``write_word_vectors``,
``read_word_vectors``, ``save_word2vec``, ``load_word2vec``).

Two formats, the JAX package's:

* text, one ``word x1 ... xD`` line per vocabulary word (word2vec's text
  output);
* the full model as a zip of ``configuration.json`` (the constructor
  arguments), ``vocab.json`` (word, count, Huffman codes and points in
  index order) and ``coefficients.npz`` (syn0, syn1 and syn1neg). A zip
  written by either package loads in the other; loading goes through
  ``Word2Vec.from_arrays``.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np

from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec


def write_word_vectors(model, path: str) -> None:
    """Text format: ``word x1 x2 ... xD`` per line, 8 significant digits."""
    lt = model.lookup_table if hasattr(model, "lookup_table") else model
    with open(path, "w", encoding="utf-8") as f:
        for w in lt.vocab.vocab_words():
            vec = lt.syn0[w.index]
            f.write(w.word + " " + " ".join(f"{v:.8g}" for v in vec) + "\n")


def read_word_vectors(path: str) -> InMemoryLookupTable:
    """A query-only lookup table from the text format, rows in file order
    (counts unknown: all 1)."""
    words, rows = [], []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < 2:
                continue
            words.append(parts[0])
            rows.append(np.array([float(x) for x in parts[1:]], np.float32))
    vocab = VocabCache()
    for w in words:
        vocab.add_token(w)
    vocab.finalize_vocab(1)
    vocab.set_order(words)
    lt = InMemoryLookupTable(vocab, rows[0].shape[0] if rows else 1)
    lt.syn0 = np.stack(rows) if rows else lt.syn0
    return lt


def save_word2vec(model: Word2Vec, path: str) -> None:
    """The full model in one zip: configuration, vocabulary with Huffman
    paths, and the tables."""
    vocab_rows = [
        {"word": w.word, "count": w.count, "codes": w.codes, "points": w.points}
        for w in model.vocab.vocab_words()
    ]
    lt = model.lookup_table
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", json.dumps(model.config()))
        zf.writestr("vocab.json", json.dumps(vocab_rows))
        buf = io.BytesIO()
        arrays = {"syn0": lt.syn0, "syn1": lt.syn1}
        if lt.syn1neg is not None:
            arrays["syn1neg"] = lt.syn1neg
        np.savez(buf, **arrays)
        zf.writestr("coefficients.npz", buf.getvalue())


def load_word2vec(path: str, device=None) -> Word2Vec:
    """A model from a zip of either package; it trains on ``device``
    (the card unless ``device="cpu"``)."""
    with zipfile.ZipFile(path, "r") as zf:
        conf = json.loads(zf.read("configuration.json"))
        vocab_rows = json.loads(zf.read("vocab.json"))
        with np.load(io.BytesIO(zf.read("coefficients.npz"))) as npz:
            arrays = {k: npz[k] for k in npz.files}
    return Word2Vec.from_arrays(conf, vocab_rows, arrays, device=device)
