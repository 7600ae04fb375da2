"""Text vectorizers: bag-of-words and TF-IDF (counterpart:
``deeplearning4j_tpu/nlp/vectorizers.py``).

Fit a vocabulary over a corpus, then turn texts into count or tf-idf
weighted vectors, optionally paired with labels into the port's
``DataSet``. Host numpy over the port's tokenizer and vocab, so the
matrices are the JAX package's bit for bit; a ``DataSet`` goes to the
card when a network fits it.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterator import DataSet
from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory, common_preprocessor
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor


class BagOfWordsVectorizer:
    """Counts per vocab word (BagOfWordsVectorizer.java)."""

    def __init__(
        self,
        min_word_frequency: int = 1,
        tokenizer: Optional[DefaultTokenizerFactory] = None,
        stop_words: Sequence[str] = (),
    ):
        self.min_word_frequency = min_word_frequency
        self.tokenizer = tokenizer or DefaultTokenizerFactory(common_preprocessor)
        self.stop_words = set(stop_words)
        self.vocab: Optional[VocabCache] = None
        self._doc_freq: Optional[np.ndarray] = None
        self.num_docs = 0

    def _tokens(self, text: str) -> List[str]:
        return [t for t in self.tokenizer.tokenize(text) if t not in self.stop_words]

    def fit(self, texts: Iterable[str]) -> "BagOfWordsVectorizer":
        token_seqs = [self._tokens(t) for t in texts]
        token_seqs = [t for t in token_seqs if t]
        self.vocab = VocabConstructor(
            self.min_word_frequency, build_huffman_tree=False
        ).build(token_seqs)
        # document frequency for idf (TfidfVectorizer tracks numDocs + word
        # doc counts through the vocab cache)
        V = self.vocab.num_words()
        df = np.zeros((V,), np.float64)
        for toks in token_seqs:
            seen = {self.vocab.index_of(t) for t in toks}
            for i in seen:
                if i >= 0:
                    df[i] += 1
        self._doc_freq = df
        self.num_docs = len(token_seqs)
        return self

    def transform(self, text: str) -> np.ndarray:
        V = self.vocab.num_words()
        vec = np.zeros((V,), np.float32)
        for t in self._tokens(text):
            i = self.vocab.index_of(t)
            if i >= 0:
                vec[i] += 1.0
        return vec

    def transform_all(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.transform(t) for t in texts])

    def vectorize(self, texts: Sequence[str], labels: Sequence[str]) -> DataSet:
        """text+label → DataSet (BaseTextVectorizer.vectorize)."""
        classes = sorted(set(labels))
        y = np.zeros((len(texts), len(classes)), np.float32)
        for i, l in enumerate(labels):
            y[i, classes.index(l)] = 1.0
        return DataSet(features=self.transform_all(texts), labels=y)


class TfidfVectorizer(BagOfWordsVectorizer):
    """tf-idf weighting (TfidfVectorizer.java: tf = count, idf =
    log(numDocs / docFreq))."""

    def transform(self, text: str) -> np.ndarray:
        counts = super().transform(text)
        df = np.maximum(self._doc_freq, 1.0)
        idf = np.log(max(1, self.num_docs) / df).astype(np.float32)
        return counts * idf
