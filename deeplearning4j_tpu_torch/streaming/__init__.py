"""Streaming inference and training (counterpart:
``deeplearning4j_tpu/streaming/``): record <-> array conversion and the
base64 record serde, ``ModelServer`` (the single-model front end over
the engine) and ``StreamingTrainingPipeline`` (a record stream ->
minibatches -> ``fit``)."""

from deeplearning4j_tpu_torch.streaming.conversion import (
    array_to_record,
    decode_record_base64,
    encode_record_base64,
    record_to_array,
)
from deeplearning4j_tpu_torch.streaming.pipeline import (
    StreamingTrainingPipeline,
)
from deeplearning4j_tpu_torch.streaming.serving import ModelServer

__all__ = [
    "record_to_array",
    "array_to_record",
    "encode_record_base64",
    "decode_record_base64",
    "ModelServer",
    "StreamingTrainingPipeline",
]
