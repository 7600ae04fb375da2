"""Data plumbing (counterpart: ``deeplearning4j_tpu/etl/``): the fitted
normalizers and the int8 calibration ``/predict`` reads from a checkpoint
zip. The pipelines, transforms, schema and stats wait for a later
slice."""
