"""Sequence parallelism on ``torch.distributed`` (counterpart:
``deeplearning4j_tpu/parallel/`` — only ``mesh.py``'s ``'data'`` and
``'seq'`` axes and ``sequence_parallel.py`` are ported, for ring and
Ulysses attention and the sequence-parallel training step with DP x SP;
data, tensor, pipeline and expert parallelism on their own and the fleet
wait for later slices).
"""
