"""Sequence parallelism on ``torch.distributed`` (counterpart:
``deeplearning4j_tpu/parallel/`` — only ``mesh.py``'s ``'seq'`` axis and
``sequence_parallel.py`` are ported; data, tensor, pipeline and expert
parallelism and the fleet wait for later slices).
"""
