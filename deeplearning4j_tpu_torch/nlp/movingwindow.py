"""Moving-window context extraction for word-level models (counterpart:
``deeplearning4j_tpu/nlp/movingwindow.py``).

``Window`` (a focus word with its context, begin and end flags),
``window_for_word_in_position`` and ``windows`` (``<s>``/``</s>``-padded
windows per token position), ``WindowConverter`` (a window as the
concatenation of its words' vectors) and ``strip_context_labels``
(``<LABEL> ... </LABEL>`` span markup removed, the spans returned). Host
Python and numpy.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BEGIN_LABEL = "<s>"
END_LABEL = "</s>"


class Window:
    """A focus word with its symmetric context (reference Window.java:35)."""

    def __init__(self, words: Sequence[str], window_size: int, begin: int, end: int):
        self.words = list(words)
        self.window_size = window_size
        self.begin = begin
        self.end = end
        self.label = ""

    @property
    def focus_word(self) -> str:
        return self.words[len(self.words) // 2]

    def is_begin_label(self) -> bool:
        return BEGIN_LABEL in self.words

    def is_end_label(self) -> bool:
        return END_LABEL in self.words

    def as_tokens(self) -> str:
        return " ".join(self.words)

    def __repr__(self) -> str:
        return f"Window({self.as_tokens()!r})"


def window_for_word_in_position(
    window_size: int, word_pos: int, sentence: Sequence[str]
) -> Window:
    """Reference Windows.windowForWordInPosition :151: window of
    `window_size` tokens centered on word_pos, padded with <s>/</s>."""
    half = window_size // 2
    words = []
    for i in range(word_pos - half, word_pos + half + 1):
        if i < 0:
            words.append(BEGIN_LABEL)
        elif i >= len(sentence):
            words.append(END_LABEL)
        else:
            words.append(sentence[i])
    return Window(words, window_size, max(0, word_pos - half),
                  min(len(sentence), word_pos + half + 1))


def windows(tokens: Sequence[str], window_size: int = 5) -> List[Window]:
    """One window per token position (reference Windows.windows :182)."""
    return [
        window_for_word_in_position(window_size, i, tokens)
        for i in range(len(tokens))
    ]


class WindowConverter:
    """Window -> training example: concatenation of the context words'
    embedding vectors (reference WindowConverter.asExampleMatrix)."""

    @staticmethod
    def as_example(window: Window, vectors: Dict[str, np.ndarray],
                   layer_size: int) -> np.ndarray:
        out = np.zeros((len(window.words), layer_size), np.float32)
        for i, w in enumerate(window.words):
            v = vectors.get(w)
            if v is not None:
                out[i] = v
        return out.reshape(-1)


_LABEL_RE = re.compile(r"<([A-Za-z0-9_]+)>\s*(.*?)\s*</\1>", re.DOTALL)


def strip_context_labels(text: str) -> Tuple[str, List[Tuple[str, str]]]:
    """Remove <LABEL>span</LABEL> markup, returning (plain text,
    [(label, span_text), ...]) — reference ContextLabelRetriever role."""
    spans: List[Tuple[str, str]] = []

    def repl(m: "re.Match[str]") -> str:
        spans.append((m.group(1), m.group(2)))
        return m.group(2)

    plain = _LABEL_RE.sub(repl, text)
    return re.sub(r"\s+", " ", plain).strip(), spans
