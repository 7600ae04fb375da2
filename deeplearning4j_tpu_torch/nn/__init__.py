"""The port's network side: the config DSL (``conf``), the layer runtimes
(``layers``) and ``MultiLayerNetwork`` (counterpart:
``deeplearning4j_tpu/nn``)."""
