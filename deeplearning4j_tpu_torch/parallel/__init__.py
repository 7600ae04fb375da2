"""Distributed training on ``torch.distributed`` (counterpart:
``deeplearning4j_tpu/parallel/``): ``mesh.py`` (named mesh axes as
process groups and the differentiable collectives), ``sequence_parallel``
(ring and Ulysses attention), ``expert_parallel``, ``tensor_parallel``,
``pipeline_parallel``, ``data_parallel`` (``ParallelWrapper``,
``ParameterAveragingTrainer``), ``training_master``, ``multihost`` and
``stats``. The serving fleet (``fleet.py``, ``statetracker.py``) is not
ported yet.
"""
