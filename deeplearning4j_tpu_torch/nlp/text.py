"""Tokenizers and sentence iterators of the port (counterpart:
``deeplearning4j_tpu/nlp/text.py`` — ``common_preprocessor``,
``Tokenizer``, ``DefaultTokenizerFactory``, ``SentenceIterator``,
``CollectionSentenceIterator`` and ``LineSentenceIterator``).

Host-side Python, the same rules as the JAX package's, so both packages
split a corpus into the same tokens. The n-gram and part-of-speech
tokenizers and the file and aggregating iterators are not ported yet.
"""

from __future__ import annotations

import re
from typing import Callable, Iterator, List, Optional, Sequence

_PUNCT_RE = re.compile(r"[^\w]+", re.UNICODE)


def common_preprocessor(token: str) -> str:
    """Lowercase and strip every non-word character (DL4J's
    CommonPreprocessor)."""
    return _PUNCT_RE.sub("", token.lower())


class Tokenizer:
    """The tokens of one string: has_more_tokens / next_token /
    get_tokens."""

    def __init__(self, tokens: List[str]):
        self._tokens = tokens
        self._pos = 0

    def has_more_tokens(self) -> bool:
        return self._pos < len(self._tokens)

    def next_token(self) -> str:
        tok = self._tokens[self._pos]
        self._pos += 1
        return tok

    def count_tokens(self) -> int:
        return len(self._tokens)

    def get_tokens(self) -> List[str]:
        return list(self._tokens)


class DefaultTokenizerFactory:
    """Split on whitespace, apply the optional per-token preprocessor, drop
    empty tokens."""

    def __init__(self, preprocessor: Optional[Callable[[str], str]] = None):
        self.preprocessor = preprocessor

    def create(self, text: str) -> Tokenizer:
        toks = text.split()
        if self.preprocessor is not None:
            toks = [self.preprocessor(t) for t in toks]
        return Tokenizer([t for t in toks if t])

    def tokenize(self, text: str) -> List[str]:
        return self.create(text).get_tokens()


class SentenceIterator:
    """Iterates sentences, each passed through the optional
    preprocessor."""

    def __init__(self, preprocessor: Optional[Callable[[str], str]] = None):
        self.preprocessor = preprocessor

    def _iter(self) -> Iterator[str]:  # subclass hook
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        for s in self._iter():
            yield self.preprocessor(s) if self.preprocessor else s

    def reset(self) -> None:
        pass


class CollectionSentenceIterator(SentenceIterator):
    """An in-memory list of sentences."""

    def __init__(self, sentences: Sequence[str], preprocessor=None):
        super().__init__(preprocessor)
        self.sentences = list(sentences)

    def _iter(self) -> Iterator[str]:
        return iter(self.sentences)


class LineSentenceIterator(SentenceIterator):
    """One sentence per non-empty line of a text file."""

    def __init__(self, path: str, preprocessor=None, encoding: str = "utf-8"):
        super().__init__(preprocessor)
        self.path = path
        self.encoding = encoding

    def _iter(self) -> Iterator[str]:
        with open(self.path, "r", encoding=self.encoding) as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    yield line
