"""Training data for the port (counterpart: ``deeplearning4j_tpu/datasets/``):
the in-memory ``DataSet`` and ``ListDataSetIterator`` that
``MultiLayerNetwork.fit_iterator`` consumes, and the MNIST fetcher
(``fetchers``: local idx files or the seeded stand-in). The other
datasets, the downloads, the async and pipeline iterators wait for a
later slice."""
