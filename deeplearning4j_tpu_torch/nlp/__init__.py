"""Word2Vec and its text stack, ported (counterpart:
``deeplearning4j_tpu/nlp/``): tokenizers and sentence iterators,
vocabulary, Huffman codes, the lookup table, skip-gram (hierarchical
softmax plus negative sampling through K3) and CBOW training, and the
word-vector files. GloVe, ParagraphVectors, the vectorizers and the n-gram
and part-of-speech tokenizers are not ported yet.
"""

from deeplearning4j_tpu_torch.nlp.huffman import build_huffman
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.serializer import (
    load_word2vec,
    read_word_vectors,
    save_word2vec,
    write_word_vectors,
)
from deeplearning4j_tpu_torch.nlp.text import (
    CollectionSentenceIterator,
    DefaultTokenizerFactory,
    LineSentenceIterator,
    common_preprocessor,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    VocabCache,
    VocabConstructor,
    VocabWord,
)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

__all__ = [
    "build_huffman",
    "InMemoryLookupTable",
    "load_word2vec",
    "read_word_vectors",
    "save_word2vec",
    "write_word_vectors",
    "CollectionSentenceIterator",
    "DefaultTokenizerFactory",
    "LineSentenceIterator",
    "common_preprocessor",
    "VocabCache",
    "VocabConstructor",
    "VocabWord",
    "Word2Vec",
]
