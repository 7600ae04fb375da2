"""PyTorch + CUDA port of ``deeplearning4j_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; this package mirrors
its module paths (``ops/``, ``nn/``, ``optimize/``, ``datasets/``,
``models/``, ``parallel/``, ``serving/``, ``utils/``) so a reader finds each counterpart
by name. It imports ``torch``, numpy and the standard library only —
never ``jax`` and nothing of ``deeplearning4j_tpu``.

Ported so far, two serving paths, the training paths below and the
long-context forward:

* paged-KV ``/generate`` of the TransformerLM:
  ``models.transformer.TransformerLM`` -> ``serving.paged.PagedDecoder``
  -> ``serving.engine.ServingEngine``;
* ``/predict`` of a MultiLayerNetwork (the char-RNN first):
  ``nn.conf`` -> ``nn.multilayer.MultiLayerNetwork`` ->
  ``serving.batcher.DynamicBatcher`` / ``serving.registry.ModelRegistry``
  -> ``serving.engine.ServingEngine``;
* training of a MultiLayerNetwork (the char-RNN with truncated BPTT
  first): ``nn.multilayer.MultiLayerNetwork.fit`` / ``fit_iterator`` with
  ``nn.losses`` and ``optimize.updaters``, checkpoints through
  ``utils.serialization.write_model`` and ``MultiLayerNetwork.load``;
* Word2Vec skip-gram training (hierarchical softmax plus negative
  sampling) and CBOW: ``nlp.word2vec.Word2Vec.fit`` / ``fit_tokens`` on
  ``nlp.{text,vocab,huffman,lookup}``, files through
  ``nlp.serializer.save_word2vec`` / ``load_word2vec``;
* the TransformerLM's long-context forward over a ``'seq'`` process
  group: ``models.transformer.ring_forward`` on
  ``parallel.sequence_parallel`` (ring attention, Ulysses) and
  ``parallel.mesh``;
* MultiLayerNetworks of ``MultiHeadAttention`` layers
  (``nn.layers.attention``), masked batches included;
* training and sampling of the TransformerLM:
  ``models.transformer.TransformerLM.fit`` / ``fit_batches`` /
  ``fit_iterator`` / ``evaluate`` (Adam, accumulation, ``ops.remat``,
  bf16 loss scaling through ``ops.lowprec``), ``save`` / ``load`` in the
  JAX zip layout, and ``generate`` with top-k / top-p (also behind
  ``/generate``);
* the CNN and layer-zoo MultiLayerNetworks: ``models.lenet``,
  ``models.alexnet``, ``models.vgg`` and ``models.dbn`` on
  ``nn.layers.convolution`` and ``nn.layers.normalization`` (PyTorch's
  own convolution and pooling, cuDNN on the card), layerwise
  pretraining (``MultiLayerNetwork.pretrain``), the full-batch solvers
  (``optimize.solvers``), ``eval.evaluation``,
  ``utils.gradient_check`` and the MNIST fetcher
  (``datasets.fetchers``).

Their six TPU kernels are hand-written CUDA C++ for sm_90a under
``csrc/``: flash prefill (``ops/flash_attention.py``), paged decode
attention (``ops/paged_attention.py``), the fused peephole-LSTM scan
with its reverse-time backward (``ops/lstm_scan.py``) and the
skip-gram negative-sampling step (``ops/sgns.py``) and flash attention
with a key bias and a visibility offset (``ops/flash_attention.py``,
beside the flash prefill); so is the flash backward that training runs
(``flash_bwd`` in ``ops/flash_attention.py``), which the JAX package left
to XLA. All are built with ``nvcc`` at first use (``ops/build.py``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit CPU device it raises
instead of moving to the CPU.
"""
