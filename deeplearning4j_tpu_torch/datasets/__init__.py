"""Training data for the port (counterpart: ``deeplearning4j_tpu/datasets/``):
the in-memory ``DataSet`` and ``ListDataSetIterator`` that
``MultiLayerNetwork.fit_iterator`` consumes. The fetchers, the async and
pipeline iterators wait for a later slice."""
