"""Training data for the port (counterpart: ``deeplearning4j_tpu/datasets/``):
the in-memory ``DataSet`` and its iterators (``ListDataSetIterator``,
the async, multi-epoch and sampling cursors), the record readers and
their iterators (``records``), the image loader and reader (``image``),
and the local datasets (``fetchers``: MNIST, Iris, CIFAR-10, LFW and
curves from local files or the seeded stand-ins). The port downloads
nothing."""
