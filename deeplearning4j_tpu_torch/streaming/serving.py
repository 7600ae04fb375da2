"""The single-model server front end (counterpart:
``deeplearning4j_tpu/streaming/serving.py``): a thin subclass of the
port's ``ServingEngine`` with the original contract — construct with a
live network or a checkpoint zip, ``start()``, post records at ``url``.

  POST /predict   {"record": [..floats..]}            -> {"output": [...]}
                  {"record_base64": "<b64 floats>"}   -> {"output": [...]}
                  {"batch": [[...], ...]}             -> {"outputs": [[...], ...]}
  POST /generate  {"tokens": [[ids]], "n_new": K, ...} -> {"tokens": [[ids]]}
  GET  /health, GET /metrics as the engine answers them.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.serving.engine import ServingEngine


class ModelServer(ServingEngine):
    """The original single-model server contract over the engine (its
    batcher, decoders, breakers and registry). ``device``: ``cuda``
    unless ``"cpu"``."""

    def __init__(self, model=None, model_path: Optional[str] = None,
                 port: int = 0, input_shape=None, **engine_kwargs) -> None:
        if model is None and model_path is None:
            raise ValueError("need model or model_path")
        super().__init__(model=model, model_path=model_path, port=port,
                         input_shape=input_shape, **engine_kwargs)

    def start(self) -> "ModelServer":
        super().start()
        return self
