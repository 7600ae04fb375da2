"""TextPipeline, partitioned corpus processing and the vocab build
(counterpart: ``deeplearning4j_tpu/nlp/text_pipeline.py``).

Tokenize partitions of the corpus on a thread pool, count words with one
``Counter`` a partition, merge the counts, filter by
``min_word_frequency``, and build the vocab cache and Huffman coding
through the port's ``VocabConstructor``. Counting is associative, so the
vocab and codes do not depend on the partitioning: they equal a serial
``VocabConstructor.build`` over the same token sequences. Host Python.
"""

from __future__ import annotations

from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, Sequence

from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory, common_preprocessor
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor


def _partition(items: List, n: int) -> List[List]:
    k = max(1, -(-len(items) // max(1, n)))
    return [items[i : i + k] for i in range(0, len(items), k)]


class TextPipeline:
    """tokenize -> per-partition count -> merge -> filter -> vocab/Huffman."""

    def __init__(
        self,
        min_word_frequency: int = 1,
        num_partitions: int = 8,
        num_workers: Optional[int] = None,
        tokenizer: Optional[DefaultTokenizerFactory] = None,
        stop_words: Sequence[str] = (),
    ):
        self.min_word_frequency = min_word_frequency
        self.num_partitions = max(1, num_partitions)
        self.num_workers = num_workers or self.num_partitions
        self.tokenizer = tokenizer or DefaultTokenizerFactory(common_preprocessor)
        self.stop_words = set(stop_words)
        self.token_sequences: Optional[List[List[str]]] = None
        self.word_counts: Optional[Counter] = None
        self.vocab: Optional[VocabCache] = None

    # -- stage 1: tokenize (map) ------------------------------------------
    def _tokenize_partition(self, sentences: List[str]) -> List[List[str]]:
        out = []
        for s in sentences:
            toks = [
                t for t in self.tokenizer.tokenize(s) if t not in self.stop_words
            ]
            if toks:
                out.append(toks)
        return out

    # -- stage 2: count (per-partition accumulator) ------------------------
    @staticmethod
    def _count_partition(token_seqs: List[List[str]]) -> Counter:
        c: Counter = Counter()
        for toks in token_seqs:
            c.update(toks)
        return c

    def fit(self, sentences: Iterable[str]) -> "TextPipeline":
        """Run the full pipeline (TextPipeline.buildVocabCache role)."""
        parts = _partition(list(sentences), self.num_partitions)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            tokenized = list(pool.map(self._tokenize_partition, parts))
            counters = list(pool.map(self._count_partition, tokenized))
        # the associative merge of the partitions' counts (Spark's
        # accumulator value())
        merged: Counter = Counter()
        for c in counters:
            merged.update(c)
        self.word_counts = merged
        self.token_sequences = [seq for part in tokenized for seq in part]
        # filter + index + Huffman via the standard constructor
        self.vocab = VocabConstructor(self.min_word_frequency).build(
            self.token_sequences
        )
        return self

    def filtered_counts(self) -> Counter:
        assert self.word_counts is not None, "call fit() first"
        return Counter(
            {
                w: c
                for w, c in self.word_counts.items()
                if c >= self.min_word_frequency
            }
        )
