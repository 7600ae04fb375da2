"""Vocabulary of the port (counterpart: ``deeplearning4j_tpu/nlp/vocab.py``
— ``VocabWord``, ``VocabCache``, ``VocabConstructor``).

Words are counted, those below ``min_word_frequency`` dropped, and the
rest indexed by descending count, ties by the word itself: the JAX
package's order, so a word has the same row in both packages' tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

from deeplearning4j_tpu_torch.nlp.huffman import build_huffman


@dataclass
class VocabWord:
    """A word, its count, its index and its Huffman path (codes are the
    branch bits, points the inner-node rows of syn1)."""

    word: str
    count: float = 1.0
    index: int = -1
    codes: List[int] = field(default_factory=list)
    points: List[int] = field(default_factory=list)

    @property
    def code_length(self) -> int:
        return len(self.codes)


class VocabCache:
    """Word <-> index store with counts."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_occurrences: float = 0.0

    def add_token(self, word: str, count: float = 1.0) -> VocabWord:
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word=word, count=0.0)
            self._words[word] = vw
        vw.count += count
        return vw

    def finalize_vocab(self, min_word_frequency: int = 1) -> None:
        """Drop rare words, index the rest by descending count (ties by
        word), recompute the total."""
        kept = [w for w in self._words.values() if w.count >= min_word_frequency]
        kept.sort(key=lambda w: (-w.count, w.word))
        self._words = {w.word: w for w in kept}
        self._by_index = kept
        for i, w in enumerate(kept):
            w.index = i
        self.total_word_occurrences = float(sum(w.count for w in kept))

    def set_order(self, words: Sequence[str]) -> None:
        """Index the words in the given order (a loaded model's rows)."""
        self._by_index = [self._words[w] for w in words]
        for i, vw in enumerate(self._by_index):
            vw.index = i

    def build_huffman(self) -> None:
        build_huffman(self._by_index)

    def __contains__(self, word: str) -> bool:
        return word in self._words

    def __len__(self) -> int:
        return len(self._by_index)

    def num_words(self) -> int:
        return len(self._by_index)

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return -1 if vw is None else vw.index

    def word_at_index(self, index: int) -> str:
        return self._by_index[index].word

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def word_frequency(self, word: str) -> float:
        vw = self._words.get(word)
        return 0.0 if vw is None else vw.count


class VocabConstructor:
    """Counts tokenized sequences into a finalized VocabCache, with Huffman
    codes unless told otherwise."""

    def __init__(self, min_word_frequency: int = 1, build_huffman_tree: bool = True):
        self.min_word_frequency = min_word_frequency
        self.build_huffman_tree = build_huffman_tree

    def build(self, token_sequences: Iterable[Sequence[str]]) -> VocabCache:
        cache = VocabCache()
        for seq in token_sequences:
            for tok in seq:
                cache.add_token(tok)
        cache.finalize_vocab(self.min_word_frequency)
        if self.build_huffman_tree:
            cache.build_huffman()
        return cache
