"""Tokenizers, sentence iterators and labelled documents of the port
(counterpart: ``deeplearning4j_tpu/nlp/text.py`` — ``STOP_WORDS``,
``common_preprocessor``, ``Tokenizer``, ``DefaultTokenizerFactory``,
``NGramTokenizerFactory``, ``PosFilterTokenizerFactory`` :117, the
``SentenceIterator`` family,
``LabelledDocument`` and ``BasicLabelAwareIterator``).

Host-side Python, the same rules as the JAX package's, so both packages
split a corpus into the same tokens. ``PosFilterTokenizerFactory`` tags
through the port's ``nlp/treeparser.AveragedPerceptronTagger``.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

# the English stop words the JAX package bundles
STOP_WORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with he she his her
    him from we you your i me my our us were been has have had do does did
    what when where who whom which why how all any both each few more most
    other some than too very can just should now""".split()
)

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


class NGramTokenizerFactory:
    """Every n-gram for n in [min_n, max_n] of the base tokenizer's
    tokens, joined by spaces, the unigrams first."""

    def __init__(self, base: Optional[DefaultTokenizerFactory] = None,
                 min_n: int = 1, max_n: int = 1):
        self.base = base or DefaultTokenizerFactory()
        self.min_n = min_n
        self.max_n = max_n

    def create(self, text: str) -> Tokenizer:
        unigrams = self.base.tokenize(text)
        out: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            if n == 1:
                out.extend(unigrams)
            else:
                out.extend(" ".join(unigrams[i:i + n])
                           for i in range(len(unigrams) - n + 1))
        return Tokenizer(out)

    def tokenize(self, text: str) -> List[str]:
        return self.create(text).get_tokens()


class PosFilterTokenizerFactory:
    """A part-of-speech filtering tokenizer: tokens whose tag (from
    ``nlp/treeparser.AveragedPerceptronTagger``) is not in
    ``allowed_tags`` become "NONE", so positions are kept, or are dropped
    with ``drop=True``."""

    PLACEHOLDER = "NONE"

    def __init__(self, allowed_tags: Sequence[str], tagger=None,
                 base: Optional[DefaultTokenizerFactory] = None,
                 drop: bool = False):
        from deeplearning4j_tpu_torch.nlp.treeparser import (
            AveragedPerceptronTagger,
        )

        self.allowed = set(allowed_tags)
        self.tagger = tagger or AveragedPerceptronTagger()
        self.base = base or DefaultTokenizerFactory()
        self.drop = drop

    def create(self, text: str) -> Tokenizer:
        words = self.base.tokenize(text)
        tags = self.tagger.tag(words)
        if self.drop:
            kept = [w for w, t in zip(words, tags) if t in self.allowed]
        else:
            kept = [w if t in self.allowed else self.PLACEHOLDER
                    for w, t in zip(words, tags)]
        return Tokenizer(kept)

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


class FileSentenceIterator(SentenceIterator):
    """The lines of a file, or of every file under a directory in sorted
    path order."""

    def __init__(self, root: str, preprocessor=None, encoding: str = "utf-8"):
        super().__init__(preprocessor)
        self.root = root
        self.encoding = encoding

    def _iter(self) -> Iterator[str]:
        if os.path.isfile(self.root):
            paths = [self.root]
        else:
            paths = [os.path.join(dirpath, name)
                     for dirpath, _dirs, files in os.walk(self.root)
                     for name in files]
        for p in sorted(paths):
            yield from LineSentenceIterator(p, encoding=self.encoding)._iter()


class AggregatingSentenceIterator(SentenceIterator):
    """Several sentence iterators one after another (their own
    preprocessors are not applied, this one's is)."""

    def __init__(self, iterators: Sequence[SentenceIterator], preprocessor=None):
        super().__init__(preprocessor)
        self.iterators = list(iterators)

    def _iter(self) -> Iterator[str]:
        for it in self.iterators:
            yield from it._iter()


@dataclass
class LabelledDocument:
    """A document's text and its labels (ParagraphVectors' input)."""

    content: str
    labels: List[str] = field(default_factory=list)


class BasicLabelAwareIterator:
    """One LabelledDocument per sentence, labelled from ``labels`` or
    ``<label_prefix><n>``."""

    def __init__(self, sentences: Iterable[str],
                 labels: Optional[Sequence[str]] = None,
                 label_prefix: str = "DOC_"):
        self.documents: List[LabelledDocument] = [
            LabelledDocument(content=s, labels=[
                labels[i] if labels is not None else f"{label_prefix}{i}"])
            for i, s in enumerate(sentences)]

    def __iter__(self) -> Iterator[LabelledDocument]:
        return iter(self.documents)

    def all_labels(self) -> List[str]:
        """Every label once, in order of first appearance."""
        return list(dict.fromkeys(l for d in self.documents for l in d.labels))
