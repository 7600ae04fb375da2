"""Runtime layers of the port (counterpart:
``deeplearning4j_tpu/nn/layers``): dense, output, RNN output and
GravesLSTM, inference side."""
