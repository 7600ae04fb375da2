"""Data plumbing (counterpart: ``deeplearning4j_tpu/etl/``): the typed
schema and ``TransformProcess`` (``schema``, ``transforms``), the fitted
normalizers and the int8 calibration ``/predict`` reads from a checkpoint
zip (``normalize``, ``calibrate``), the overlapped ``InputPipeline`` with
its stager (``pipeline``) and its telemetry (``stats``)."""

from deeplearning4j_tpu_torch.etl.pipeline import (  # noqa: F401
    InputPipeline,
    Stager,
    maybe_wrap,
)
from deeplearning4j_tpu_torch.etl.schema import ColumnType, Schema  # noqa: F401
from deeplearning4j_tpu_torch.etl.stats import PipelineStats  # noqa: F401
from deeplearning4j_tpu_torch.etl.transforms import (  # noqa: F401
    TransformProcess,
)
