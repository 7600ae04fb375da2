"""Constituency trees, PoS tagging and tree parsing (counterpart:
``deeplearning4j_tpu/nlp/treeparser.py``).

  - ``Tree``: the constituency-tree structure (label, value, tokens,
    children; yield, leaves, preterminal tests, depth, clone).
  - Penn-treebank s-expression read and write (``parse_sexpr``,
    ``Tree.to_sexpr``).
  - ``BinarizeTreeTransformer``: left-factored binarization with
    intermediate "@" labels, so every node has at most 2 children.
  - ``CollapseUnaries``: unary chains X -> Y -> children squeezed into
    X -> children.
  - ``HeadWordFinder``: a Collins-style two-pass head-rule table with a
    terminal-tag fallback.
  - ``AveragedPerceptronTagger``: a trainable PoS tagger (averaged
    perceptron over contextual and orthographic features) with a rule
    lexicon fallback.
  - ``Pcfg`` and CKY: a probabilistic grammar estimated from trees,
    Viterbi CKY decoding.
  - ``TreeParser``: text -> sentences -> tokens -> tags -> trees; with no
    grammar trained, a deterministic tag-pattern chunker gives shallow
    NP/VP/PP trees.
  - ``TreeVectorizer``: trees with per-node gold labels.
  - ``TreeIterator``: minibatches of labelled trees.

Everything here is host-side data preparation with no device compute, so
it stays plain Python and numpy, the JAX package's code with the port's
imports. The perceptron's weights and the grammar's tables are plain
dicts filled in the same order as the JAX module fills them, so both
packages give the same tags and trees.
"""

from __future__ import annotations

import math
import random
import re
from collections import Counter, defaultdict
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Tree",
    "parse_sexpr",
    "BinarizeTreeTransformer",
    "CollapseUnaries",
    "HeadWordFinder",
    "AveragedPerceptronTagger",
    "Pcfg",
    "TreeParser",
    "TreeVectorizer",
    "TreeIterator",
]


# ---------------------------------------------------------------------------
# Tree
# ---------------------------------------------------------------------------


class Tree:
    """Constituency-tree node (reference recursive/Tree.java:32).

    ``label`` is the syntactic category (NP/VP/... or a PoS tag for
    preterminals), ``value`` the token at a leaf. ``gold_label`` is an int
    class index used by TreeVectorizer; ``vector``/``prediction``/``error``
    are slots recursive models fill in during training.
    """

    __slots__ = (
        "label", "value", "children", "parent", "tokens", "tags",
        "gold_label", "vector", "prediction", "error", "head_word",
    )

    def __init__(self, label: str = "", value: Optional[str] = None,
                 children: Optional[List["Tree"]] = None,
                 tokens: Optional[List[str]] = None):
        self.label = label
        self.value = value
        self.children: List[Tree] = []
        self.parent: Optional[Tree] = None
        self.tokens: List[str] = list(tokens or [])
        self.tags: List[str] = []
        self.gold_label: int = -1
        self.vector: Optional[np.ndarray] = None
        self.prediction: Optional[np.ndarray] = None
        self.error: float = 0.0
        self.head_word: Optional[str] = None
        for c in children or []:
            self.connect(c)

    # -- structure -----------------------------------------------------------
    def connect(self, child: "Tree") -> "Tree":
        child.parent = self
        self.children.append(child)
        return self

    def is_leaf(self) -> bool:
        return not self.children

    def is_preterminal(self) -> bool:
        """One child and that child is a leaf (reference Tree.java:162)."""
        return len(self.children) == 1 and self.children[0].is_leaf()

    def first_child(self) -> Optional["Tree"]:
        return self.children[0] if self.children else None

    def last_child(self) -> Optional["Tree"]:
        return self.children[-1] if self.children else None

    def depth(self) -> int:
        """Max distance to a leaf (reference Tree.java:188)."""
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def yield_(self) -> List[str]:
        """Leaf tokens left-to-right (reference Tree.java:94)."""
        return [leaf.value for leaf in self.leaves() if leaf.value is not None]

    def leaves(self) -> List["Tree"]:
        if self.is_leaf():
            return [self]
        out: List[Tree] = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    def preterminals(self) -> List["Tree"]:
        if self.is_preterminal():
            return [self]
        out: List[Tree] = []
        for c in self.children:
            out.extend(c.preterminals())
        return out

    def subtrees(self) -> List["Tree"]:
        out = [self]
        for c in self.children:
            out.extend(c.subtrees())
        return out

    def error_sum(self) -> float:
        """Total error over the subtree (reference Tree.java:273)."""
        return self.error + sum(c.error_sum() for c in self.children)

    def ancestor(self, height: int) -> Optional["Tree"]:
        node: Optional[Tree] = self
        for _ in range(height):
            if node is None:
                return None
            node = node.parent
        return node

    def clone(self) -> "Tree":
        t = Tree(self.label, self.value)
        t.tokens = list(self.tokens)
        t.tags = list(self.tags)
        t.gold_label = self.gold_label
        t.head_word = self.head_word
        for c in self.children:
            t.connect(c.clone())
        return t

    # -- IO ------------------------------------------------------------------
    def to_sexpr(self) -> str:
        if self.is_leaf():
            return self.value if self.value is not None else self.label
        inner = " ".join(c.to_sexpr() for c in self.children)
        return f"({self.label} {inner})"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Tree({self.to_sexpr()!r})"

    def __eq__(self, other) -> bool:
        if not isinstance(other, Tree):
            return NotImplemented
        return self.to_sexpr() == other.to_sexpr()

    def __hash__(self) -> int:
        return hash(self.to_sexpr())


_SEXPR_TOKEN = re.compile(r"\(|\)|[^\s()]+")


def parse_sexpr(s: str) -> Tree:
    """Parse a Penn-treebank bracketed string into a :class:`Tree`."""
    toks = _SEXPR_TOKEN.findall(s)
    if not toks:
        raise ValueError("empty s-expression")
    pos = 0

    def parse() -> Tree:
        nonlocal pos
        if toks[pos] != "(":
            raise ValueError(f"expected '(' at token {pos}: {toks[pos]!r}")
        pos += 1
        label = ""
        if toks[pos] not in "()":
            label = toks[pos]
            pos += 1
        node = Tree(label)
        while pos < len(toks) and toks[pos] != ")":
            if toks[pos] == "(":
                node.connect(parse())
            else:
                node.connect(Tree(label="", value=toks[pos]))
                pos += 1
        if pos >= len(toks):
            raise ValueError("unbalanced s-expression")
        pos += 1  # consume ')'
        return node

    tree = parse()
    if pos != len(toks):
        raise ValueError("trailing content after s-expression")
    tree.tokens = tree.yield_()
    return tree


# ---------------------------------------------------------------------------
# Transformers
# ---------------------------------------------------------------------------


class BinarizeTreeTransformer:
    """Left-factored binarization: nodes with >2 children become nested
    binary nodes with intermediate "@LABEL" markers (reference
    BinarizeTreeTransformer.java:36 — same capability; the reference labels
    intermediates "LABEL-(childlabels"; "@" is the common Stanford form).
    Reversible via :meth:`unbinarize`."""

    MARK = "@"

    def transform(self, t: Tree) -> Tree:
        t = t.clone()
        self._binarize(t)
        return t

    def _binarize(self, node: Tree) -> None:
        for c in node.children:
            self._binarize(c)
        while len(node.children) > 2:
            # fold the leftmost two children under an intermediate node
            left, second = node.children[0], node.children[1]
            inter = Tree(self.MARK + node.label.lstrip(self.MARK))
            inter.connect(left)
            inter.connect(second)
            node.children = [inter] + node.children[2:]
            inter.parent = node

    def unbinarize(self, t: Tree) -> Tree:
        t = t.clone()
        self._unbinarize(t)
        return t

    def _unbinarize(self, node: Tree) -> None:
        new_children: List[Tree] = []
        for c in node.children:
            self._unbinarize(c)
            if c.label.startswith(self.MARK):
                new_children.extend(c.children)
            else:
                new_children.append(c)
        for c in new_children:
            c.parent = node
        node.children = new_children


class CollapseUnaries:
    """Collapse unary chains X -> Y -> [...] into X -> [...] (reference
    CollapseUnaries.java:33 — keeps the top label, drops intermediates;
    preterminals are untouched)."""

    def transform(self, tree: Tree) -> Tree:
        if tree.is_preterminal() or tree.is_leaf():
            return tree.clone()
        children = tree.children
        while len(children) == 1 and not children[0].is_leaf() \
                and not children[0].is_preterminal():
            children = children[0].children
        ret = Tree(tree.label)
        ret.tokens = list(tree.tokens)
        ret.gold_label = tree.gold_label
        for c in children:
            ret.connect(self.transform(c))
        return ret


class HeadWordFinder:
    """Collins-style head finding (reference HeadWordFinder.java:32): a
    first-pass category->head-tag preference table, a second-pass fallback
    table, then terminal-tag scan, then the leftmost child."""

    # category -> ordered head-child label preferences (pass 1 then pass 2);
    # compact rendition of the reference's head1/head2 string tables.
    _PASS1: Dict[str, List[str]] = {
        "ADJP": ["JJ", "JJR", "JJS"],
        "ADVP": ["RB", "RBR", "RBS"],
        "NAC": ["NNS", "NN", "PRP", "NNPS", "NNP"],
        "NX": ["NNS", "NN", "PRP", "NNPS", "NNP"],
        "NP": ["NNS", "NN", "PRP", "NNPS", "NNP", "POS", "$"],
        "PP": ["IN", "TO", "RP"],
        "PRT": ["RP"],
        "S": ["VP"],
        "S1": ["S"],
        "SBAR": ["IN", "WHNP"],
        "SBARQ": ["SQ", "VP"],
        "SINV": ["VP"],
        "SQ": ["MD", "AUX"],
        "VP": ["VB", "VBZ", "VBP", "VBG", "VBN", "VBD", "AUX", "TO", "MD"],
        "WHADJP": ["WRB"],
        "WHADVP": ["WRB"],
        "WHNP": ["WP", "WDT", "WP$"],
        "WHPP": ["IN", "TO"],
    }
    _PASS2: Dict[str, List[str]] = {
        "ADJP": ["VBN", "RB"],
        "NAC": ["NP", "CD", "FW", "ADJP", "JJ"],
        "NX": ["NP", "CD", "FW", "ADJP", "JJ"],
        "NP": ["CD", "ADJP", "JJ"],
        "S": ["SINV", "SBARQ", "X"],
        "PRT": ["RB", "IN"],
        "SBAR": ["WHADJP", "WHADVP", "WHPP"],
        "SBARQ": ["S", "SINV", "X"],
        "SINV": ["SBAR"],
        "SQ": ["VP"],
    }
    _TERMINALS = {"AUX", "AUXG", "CC", "CD", "DT", "EX", "FW", "IN", "JJ",
                  "JJR", "JJS", "LS", "MD", "NN", "NNS", "NNP", "NNPS",
                  "PDT", "POS", "PRP", "PRP$", "RB", "RBR", "RBS", "RP",
                  "SYM", "TO", "UH", "VB", "VBD", "VBG", "VBN", "VBP",
                  "VBZ", "WDT", "WP", "WP$", "WRB"}

    def find_head(self, node: Tree) -> Optional[Tree]:
        """Head CHILD of ``node`` (reference findHead :214). For a
        preterminal, the node itself."""
        if node.is_leaf():
            return node
        if node.is_preterminal():
            return node
        for table in (self._PASS1, self._PASS2):
            prefs = table.get(node.label.lstrip(BinarizeTreeTransformer.MARK))
            if not prefs:
                continue
            for pref in prefs:
                for c in node.children:
                    if c.label == pref:
                        return c
        for c in node.children:
            if c.label in self._TERMINALS:
                return c
        return node.first_child()

    def head_word(self, node: Tree) -> Optional[str]:
        """Recurse through head children to the lexical head token."""
        cur = node
        while cur is not None and not cur.is_leaf():
            nxt = self.find_head(cur)
            if nxt is cur:  # preterminal: descend into the leaf
                nxt = cur.first_child()
            cur = nxt
        return cur.value if cur is not None else None

    def annotate(self, tree: Tree) -> Tree:
        """Set ``head_word`` on every subtree."""
        for sub in tree.subtrees():
            sub.head_word = self.head_word(sub)
        return tree


# ---------------------------------------------------------------------------
# PoS tagging — averaged perceptron
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"^[\d.,:-]*\d[\d.,:-]*$")

# suffix/shape fallback used before any training and for OOV bootstrapping
_RULES: List[Tuple[re.Pattern, str]] = [
    (re.compile(r".*ing$"), "VBG"),
    (re.compile(r".*ed$"), "VBD"),
    (re.compile(r".*ly$"), "RB"),
    (re.compile(r".*ous$|.*ful$|.*ive$|.*able$|.*al$"), "JJ"),
    (re.compile(r".*s$"), "NNS"),
]
_CLOSED = {
    "the": "DT", "a": "DT", "an": "DT", "this": "DT", "that": "DT",
    "is": "VBZ", "are": "VBP", "was": "VBD", "were": "VBD", "be": "VB",
    "and": "CC", "or": "CC", "but": "CC",
    "of": "IN", "in": "IN", "on": "IN", "at": "IN", "with": "IN",
    "by": "IN", "for": "IN", "from": "IN", "as": "IN",
    "to": "TO", "it": "PRP", "he": "PRP", "she": "PRP", "they": "PRP",
    "i": "PRP", "we": "PRP", "you": "PRP",
    "his": "PRP$", "her": "PRP$", "their": "PRP$", "my": "PRP$",
    "not": "RB", "very": "RB", "will": "MD", "can": "MD", "may": "MD",
}


def _rule_tag(word: str) -> str:
    lw = word.lower()
    if lw in _CLOSED:
        return _CLOSED[lw]
    if word and not any(ch.isalnum() for ch in word):
        return word  # PTB convention: punctuation is its own tag (".", ",")
    if _NUM_RE.match(word):
        return "CD"
    for pat, tag in _RULES:
        if pat.match(lw):
            return tag
    if word[:1].isupper():
        return "NNP"
    return "NN"


class AveragedPerceptronTagger:
    """Averaged-perceptron PoS tagger (the trainable, in-repo replacement
    for the reference's UIMA/OpenNLP PosTagger annotator —
    PosUimaTokenizerFactory.java). Standard greedy left-to-right decoding
    with contextual + orthographic features and weight averaging; falls
    back to deterministic suffix/lexicon rules when untrained."""

    START = ["-START-", "-START2-"]
    END = ["-END-", "-END2-"]

    def __init__(self):
        self.weights: Dict[str, Dict[str, float]] = {}
        self.classes: set = set()
        self.tagdict: Dict[str, str] = {}
        self._totals: Dict[Tuple[str, str], float] = defaultdict(float)
        self._tstamps: Dict[Tuple[str, str], int] = defaultdict(int)
        self._i = 0
        self.trained = False

    # -- features ------------------------------------------------------------
    @staticmethod
    def _normalize(word: str) -> str:
        if _NUM_RE.match(word):
            return "!NUM"
        return word.lower()

    def _features(self, i: int, word: str, context: List[str],
                  prev: str, prev2: str) -> Dict[str, int]:
        feats: Dict[str, int] = {}

        def add(name, *args):
            feats[" ".join((name,) + args)] = feats.get(" ".join((name,) + args), 0) + 1

        i += len(self.START)
        add("bias")
        add("i suffix", word[-3:])
        add("i pref1", word[:1])
        add("i-1 tag", prev)
        add("i-2 tag", prev2)
        add("i tag+i-2 tag", prev, prev2)
        add("i word", context[i])
        add("i-1 tag+i word", prev, context[i])
        add("i-1 word", context[i - 1])
        add("i-1 suffix", context[i - 1][-3:])
        add("i+1 word", context[i + 1])
        add("i+1 suffix", context[i + 1][-3:])
        return feats

    def _predict(self, feats: Dict[str, int]) -> str:
        scores: Dict[str, float] = defaultdict(float)
        for f, v in feats.items():
            if f not in self.weights:
                continue
            for tag, w in self.weights[f].items():
                scores[tag] += v * w
        if not scores:
            return "NN"
        return max(self.classes, key=lambda t: (scores[t], t))

    # -- training ------------------------------------------------------------
    def train(self, tagged_sentences: Sequence[Sequence[Tuple[str, str]]],
              iterations: int = 5, seed: int = 0) -> "AveragedPerceptronTagger":
        """``tagged_sentences``: [[(word, tag), ...], ...]."""
        self._make_tagdict(tagged_sentences)
        self.classes.update(t for s in tagged_sentences for _, t in s)
        rng = random.Random(seed)
        data = list(tagged_sentences)
        for _ in range(iterations):
            rng.shuffle(data)
            for sent in data:
                words = [w for w, _ in sent]
                context = self.START + [self._normalize(w) for w in words] + self.END
                prev, prev2 = self.START
                for i, (word, gold) in enumerate(sent):
                    guess = self.tagdict.get(word.lower())
                    if guess is None:
                        feats = self._features(i, word, context, prev, prev2)
                        guess = self._predict(feats)
                        self._update(gold, guess, feats)
                    prev2, prev = prev, guess
        self._average_weights()
        self.trained = True
        return self

    def _update(self, truth: str, guess: str, feats: Dict[str, int]) -> None:
        self._i += 1
        if truth == guess:
            return
        for f in feats:
            w = self.weights.setdefault(f, {})
            for tag, delta in ((truth, 1.0), (guess, -1.0)):
                key = (f, tag)
                self._totals[key] += (self._i - self._tstamps[key]) * w.get(tag, 0.0)
                self._tstamps[key] = self._i
                w[tag] = w.get(tag, 0.0) + delta

    def _average_weights(self) -> None:
        for f, w in self.weights.items():
            for tag in list(w):
                key = (f, tag)
                total = self._totals[key] + (self._i - self._tstamps[key]) * w[tag]
                avg = total / max(1, self._i)
                if abs(avg) > 1e-12:
                    w[tag] = avg
                else:
                    del w[tag]

    def _make_tagdict(self, sentences) -> None:
        counts: Dict[str, Counter] = defaultdict(Counter)
        for sent in sentences:
            for word, tag in sent:
                counts[word.lower()][tag] += 1
        for word, tag_counts in counts.items():
            tag, n = tag_counts.most_common(1)[0]
            # unambiguous + frequent words become a closed dictionary
            if sum(tag_counts.values()) >= 3 and n / sum(tag_counts.values()) >= 0.97:
                self.tagdict[word] = tag

    # -- inference -----------------------------------------------------------
    def tag(self, words: Sequence[str]) -> List[str]:
        if not self.trained:
            return [_rule_tag(w) for w in words]
        context = self.START + [self._normalize(w) for w in words] + self.END
        tags: List[str] = []
        prev, prev2 = self.START
        for i, word in enumerate(words):
            if word and not any(ch.isalnum() for ch in word):
                tags.append(word)  # punctuation tags itself (PTB)
                prev2, prev = prev, word
                continue
            tag = self.tagdict.get(word.lower())
            if tag is None:
                feats = self._features(i, word, context, prev, prev2)
                tag = self._predict(feats)
            tags.append(tag)
            prev2, prev = prev, tag
        return tags


# ---------------------------------------------------------------------------
# PCFG + CKY
# ---------------------------------------------------------------------------


class Pcfg:
    """Probabilistic context-free grammar in Chomsky normal form, estimated
    by maximum likelihood from trees (internally binarized). Rules:
      binary  A -> B C   log-prob
      unary   A -> tag   log-prob (preterminal emissions are handled by the
                          tagger; grammar unaries are collapsed on read)
    """

    def __init__(self):
        self.binary: Dict[Tuple[str, str], List[Tuple[str, float]]] = defaultdict(list)
        self.start_symbols: Counter = Counter()

    @staticmethod
    def from_trees(trees: Iterable[Tree]) -> "Pcfg":
        g = Pcfg()
        binarizer = BinarizeTreeTransformer()
        collapse = CollapseUnaries()
        counts: Dict[str, Counter] = defaultdict(Counter)
        for tree in trees:
            t = binarizer.transform(collapse.transform(tree))
            g.start_symbols[t.label] += 1
            for node in t.subtrees():
                if node.is_leaf() or node.is_preterminal():
                    continue
                kids = [c.label for c in node.children]
                if len(kids) == 2:
                    counts[node.label][tuple(kids)] += 1
                elif len(kids) == 1:
                    # unary over a preterminal survives collapse; treat the
                    # child tag as both children of a degenerate rule
                    counts[node.label][(kids[0], "")] += 1
        for lhs, rhs_counts in counts.items():
            total = sum(rhs_counts.values())
            for rhs, n in rhs_counts.items():
                lp = math.log(n / total)
                g.binary[rhs].append((lhs, lp))
        return g

    def parse(self, tags: Sequence[str], words: Sequence[str]) -> Optional[Tree]:
        """Viterbi CKY over the tag sequence. Returns the best tree whose
        root is the most frequent training start symbol, else the best
        spanning constituent, else None."""
        n = len(tags)
        if n == 0:
            return None
        # chart[i][j]: dict label -> (logprob, backpointer)
        chart: List[List[Dict[str, Tuple[float, object]]]] = [
            [dict() for _ in range(n + 1)] for _ in range(n + 1)
        ]
        for i, (tag, word) in enumerate(zip(tags, words)):
            cell = chart[i][i + 1]
            cell[tag] = (0.0, ("leaf", word))
            # degenerate unaries lifted from single-tag constituents
            self._apply_unaries(cell)
        for span in range(2, n + 1):
            for i in range(0, n - span + 1):
                j = i + span
                cell = chart[i][j]
                for k in range(i + 1, j):
                    left, right = chart[i][k], chart[k][j]
                    for bl, (blp, _) in left.items():
                        for rl, (rlp, _) in right.items():
                            for lhs, rlp_rule in self.binary.get((bl, rl), ()):
                                score = blp + rlp + rlp_rule
                                if lhs not in cell or score > cell[lhs][0]:
                                    cell[lhs] = (score, ("bin", k, bl, rl))
                self._apply_unaries(cell)
        root_cell = chart[0][n]
        root_label = None
        for cand, _ in self.start_symbols.most_common():
            if cand in root_cell:
                root_label = cand
                break
        if root_label is None:
            # never root at a binarization-internal "@" marker — callers get
            # None and fall back to the chunker instead
            real = [l for l in root_cell
                    if not l.startswith(BinarizeTreeTransformer.MARK)]
            if not real:
                return None
            root_label = max(real, key=lambda l: root_cell[l][0])
        tree = self._build(chart, 0, n, root_label)
        return BinarizeTreeTransformer().unbinarize(tree)

    def _apply_unaries(self, cell: Dict[str, Tuple[float, object]]) -> None:
        changed = True
        while changed:
            changed = False
            for child, (clp, _) in list(cell.items()):
                for lhs, rlp in self.binary.get((child, ""), ()):
                    score = clp + rlp
                    if lhs not in cell or score > cell[lhs][0]:
                        cell[lhs] = (score, ("un", child))
                        changed = True

    def _build(self, chart, i: int, j: int, label: str) -> Tree:
        _, bp = chart[i][j][label]
        node = Tree(label)
        if bp[0] == "leaf":
            node.connect(Tree(label="", value=bp[1]))
        elif bp[0] == "un":
            node.connect(self._build(chart, i, j, bp[1]))
        else:
            _, k, bl, rl = bp
            node.connect(self._build(chart, i, k, bl))
            node.connect(self._build(chart, k, j, rl))
        return node


# ---------------------------------------------------------------------------
# TreeParser facade
# ---------------------------------------------------------------------------

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")
# word chars may contain INTERNAL '.-, (U.S., don't, 3,000) but trailing
# punctuation is its own token ("cat." -> "cat", ".")
_WORD = re.compile(r"[A-Za-z0-9$]+(?:[.,'-][A-Za-z0-9]+)*|[^\sA-Za-z0-9]")

# tag-pattern chunk grammar for the untrained fallback: maximal runs of the
# member tags become one phrase of the given label.
_CHUNKS: List[Tuple[str, set]] = [
    ("NP", {"DT", "JJ", "JJR", "JJS", "NN", "NNS", "NNP", "NNPS", "PRP",
            "PRP$", "CD"}),
    ("VP", {"MD", "VB", "VBD", "VBG", "VBN", "VBP", "VBZ", "RB", "TO"}),
    ("PP", {"IN"}),
]


class TreeParser:
    """Text -> constituency trees (reference TreeParser.java:97,363).

    With a trained :class:`Pcfg` (``fit_grammar``), sentences are CKY-parsed
    over predicted PoS tags. Untrained, a deterministic tag-pattern chunker
    produces shallow (S (NP ...) (VP ...)) trees — enough structure for
    TreeVectorizer/window features without any external model, mirroring
    how the reference degrades when UIMA models are absent."""

    def __init__(self, tagger: Optional[AveragedPerceptronTagger] = None,
                 grammar: Optional[Pcfg] = None):
        self.tagger = tagger or AveragedPerceptronTagger()
        self.grammar = grammar

    # -- building blocks -----------------------------------------------------
    @staticmethod
    def sentences(text: str) -> List[str]:
        return [s for s in _SENT_SPLIT.split(text.strip()) if s]

    @staticmethod
    def tokenize(sentence: str) -> List[str]:
        return _WORD.findall(sentence)

    def fit_grammar(self, trees: Iterable[Tree]) -> "TreeParser":
        self.grammar = Pcfg.from_trees(trees)
        return self

    # -- parsing -------------------------------------------------------------
    def parse_sentence(self, sentence: str) -> Optional[Tree]:
        words = self.tokenize(sentence)
        if not words:
            return None
        tags = self.tagger.tag(words)
        tree: Optional[Tree] = None
        if self.grammar is not None:
            tree = self.grammar.parse(tags, words)
        if tree is None:
            tree = self._chunk(words, tags)
        tree.tokens = tree.yield_()
        tree.tags = tags
        return tree

    def get_trees(self, text: str) -> List[Tree]:
        out = []
        for sent in self.sentences(text):
            t = self.parse_sentence(sent)
            if t is not None:
                out.append(t)
        return out

    def get_trees_with_labels(self, text: str, label: str,
                              labels: Sequence[str]) -> List[Tree]:
        """Trees whose every node carries ``gold_label = labels.index(label)``
        (reference TreeParser.java:216 — the label is applied tree-wide for
        sentence-level classification)."""
        idx = list(labels).index(label)
        trees = self.get_trees(text)
        for t in trees:
            for node in t.subtrees():
                node.gold_label = idx
        return trees

    @staticmethod
    def _chunk(words: List[str], tags: List[str]) -> Tree:
        root = Tree("S")
        i = 0
        n = len(words)
        while i < n:
            matched = False
            for label, members in _CHUNKS:
                if tags[i] in members:
                    j = i
                    phrase = Tree(label)
                    while j < n and tags[j] in members:
                        pre = Tree(tags[j])
                        pre.connect(Tree(label="", value=words[j]))
                        phrase.connect(pre)
                        j += 1
                    root.connect(phrase)
                    i = j
                    matched = True
                    break
            if not matched:
                pre = Tree(tags[i])
                pre.connect(Tree(label="", value=words[i]))
                root.connect(pre)
                i += 1
        root.tokens = root.yield_()
        return root


# ---------------------------------------------------------------------------
# Vectorizer + iterator
# ---------------------------------------------------------------------------


class TreeVectorizer:
    """Sentences -> labeled trees ready for recursive-model training
    (reference TreeVectorizer.java:33,65,89)."""

    def __init__(self, parser: Optional[TreeParser] = None):
        self.parser = parser or TreeParser()

    def get_trees(self, sentences: str) -> List[Tree]:
        return self.parser.get_trees(sentences)

    def get_trees_with_labels(self, sentences: str, label: str,
                              labels: Sequence[str]) -> List[Tree]:
        # reference upper-cases label comparisons (TreeVectorizer.java:89)
        norm = [l.upper() for l in labels]
        return self.parser.get_trees_with_labels(sentences, label.upper(), norm)


class TreeIterator:
    """Minibatches of labeled trees from (text, label) pairs (reference
    TreeIterator.java)."""

    def __init__(self, docs: Sequence[Tuple[str, str]], labels: Sequence[str],
                 vectorizer: Optional[TreeVectorizer] = None, batch_size: int = 32):
        self.docs = list(docs)
        self.labels = list(labels)
        self.vectorizer = vectorizer or TreeVectorizer()
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[List[Tree]]:
        batch: List[Tree] = []
        for text, label in self.docs:
            batch.extend(
                self.vectorizer.get_trees_with_labels(text, label, self.labels)
            )
            while len(batch) >= self.batch_size:
                yield batch[: self.batch_size]
                batch = batch[self.batch_size:]
        if batch:
            yield batch
