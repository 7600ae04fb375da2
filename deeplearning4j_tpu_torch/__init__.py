"""PyTorch + CUDA port of ``deeplearning4j_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; this package mirrors
its module paths (``ops/``, ``models/``, ``serving/``, ``utils/``) so a
reader finds each counterpart by name. It imports ``torch``, numpy and the
standard library only — never ``jax`` and nothing of
``deeplearning4j_tpu``.

What is ported so far is the paged-KV ``/generate`` serving path of the
TransformerLM: ``models.transformer.TransformerLM`` ->
``serving.paged.PagedDecoder`` -> ``serving.engine.ServingEngine``. Its
two TPU kernels are hand-written CUDA C++ for sm_90a under ``csrc/``:
flash prefill (``ops/flash_attention.py``) and paged decode attention
(``ops/paged_attention.py``), built with ``nvcc`` at first use
(``ops/build.py``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit CPU device it raises
instead of moving to the CPU.
"""
