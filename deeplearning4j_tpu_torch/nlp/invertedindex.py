"""An in-memory inverted index over tokenized documents (counterpart:
``deeplearning4j_tpu/nlp/invertedindex.py``).

Add tokenized documents, look up the documents that hold a word, sample
document batches, iterate over every document. A dict of postings lists;
pair it with ``utils/disk_queue.DiskBasedQueue`` to spill. Host Python.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class InvertedIndex:
    def __init__(self):
        self._docs: List[List[str]] = []
        self._labels: List[Optional[str]] = []
        self._postings: Dict[str, List[int]] = {}

    # -- building ----------------------------------------------------------
    def add_words_to_doc(
        self, words: Sequence[str], label: Optional[str] = None
    ) -> int:
        """Add one tokenized document; returns its doc id
        (LuceneInvertedIndex.addWordsToDoc)."""
        doc_id = len(self._docs)
        toks = list(words)
        self._docs.append(toks)
        self._labels.append(label)
        seen = set()
        for w in toks:
            if w not in seen:
                self._postings.setdefault(w, []).append(doc_id)
                seen.add(w)
        return doc_id

    def finish(self) -> None:
        """No-op (the reference flushes its Lucene writer here)."""

    # -- queries -----------------------------------------------------------
    def num_documents(self) -> int:
        return len(self._docs)

    def document(self, doc_id: int) -> List[str]:
        return list(self._docs[doc_id])

    def document_label(self, doc_id: int) -> Optional[str]:
        return self._labels[doc_id]

    def documents(self, word: str) -> List[int]:
        """Doc ids containing `word` (InvertedIndex.documents)."""
        return list(self._postings.get(word, []))

    def doc_frequency(self, word: str) -> int:
        return len(self._postings.get(word, []))

    def all_docs(self) -> Iterator[List[str]]:
        for d in self._docs:
            yield list(d)

    def sample(self, n: int, seed: int = 0) -> List[List[str]]:
        """Uniform sample of n documents (the reference's batch sampling for
        embedding training)."""
        if not self._docs:
            return []
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, len(self._docs), size=n)
        return [list(self._docs[i]) for i in idx]

    def eachDoc(self, fn, *_exec) -> None:  # noqa: N802 — reference name
        for d in self._docs:
            fn(list(d))
