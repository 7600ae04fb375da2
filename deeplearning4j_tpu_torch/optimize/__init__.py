"""Training machinery of the port (counterpart:
``deeplearning4j_tpu/optimize/``): the updaters with their LR policies and
gradient normalizations, and the iteration listeners. The solvers wait
for a later slice."""
