"""Runtime layers of the port (counterpart:
``deeplearning4j_tpu/nn/layers``): the whole MultiLayerNetwork zoo —
dense, output, RNN output, embedding, activation, autoencoder, RBM,
convolution, pooling, batch and local response normalization, GravesLSTM,
its bidirectional form, GRU and multi-head attention."""
