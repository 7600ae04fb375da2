"""Word2Vec and the embedding models of the text stack, ported
(counterpart: ``deeplearning4j_tpu/nlp/``): tokenizers, sentence
iterators and labelled documents, vocabulary, Huffman codes, the lookup
table, skip-gram (hierarchical softmax plus negative sampling through
K3) and CBOW training, ParagraphVectors (DBOW and DM, co-training its
words through Word2Vec), GloVe, the word-vector files, and the host
text tools: the bag-of-words and TF-IDF vectorizers, the part-of-speech
tokenizer, the tree parser, the inverted index, moving windows and the
partitioned ``TextPipeline``.
"""

from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.huffman import build_huffman
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.serializer import (
    load_word2vec,
    read_word_vectors,
    save_word2vec,
    write_word_vectors,
)
from deeplearning4j_tpu_torch.nlp.text import (
    STOP_WORDS,
    AggregatingSentenceIterator,
    BasicLabelAwareIterator,
    CollectionSentenceIterator,
    DefaultTokenizerFactory,
    FileSentenceIterator,
    LabelledDocument,
    LineSentenceIterator,
    NGramTokenizerFactory,
    PosFilterTokenizerFactory,
    common_preprocessor,
)
from deeplearning4j_tpu_torch.nlp.vectorizers import (
    BagOfWordsVectorizer,
    TfidfVectorizer,
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
    "STOP_WORDS",
    "AggregatingSentenceIterator",
    "BasicLabelAwareIterator",
    "CollectionSentenceIterator",
    "DefaultTokenizerFactory",
    "FileSentenceIterator",
    "LabelledDocument",
    "LineSentenceIterator",
    "NGramTokenizerFactory",
    "PosFilterTokenizerFactory",
    "BagOfWordsVectorizer",
    "TfidfVectorizer",
    "common_preprocessor",
    "VocabCache",
    "VocabConstructor",
    "VocabWord",
    "Word2Vec",
    "ParagraphVectors",
    "Glove",
]
