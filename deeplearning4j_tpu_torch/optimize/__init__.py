"""Training machinery of the port (counterpart:
``deeplearning4j_tpu/optimize/``): the updaters with their LR policies and
gradient normalizations, the iteration listeners, and the full-batch
solvers (line gradient descent, conjugate gradient, LBFGS) with the
Solver."""
