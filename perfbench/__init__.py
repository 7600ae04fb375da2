"""The benchmark of ``deeplearning4j_tpu_torch``, the PyTorch and CUDA port.

Driven by data: ``BENCHMARK.json`` at the root names each cell's
configuration, traffic mix and metrics, and the harness finds each by
name under this folder:

- ``configs/<config>.json``: the model's published sizes as run, the
  departures, the precision;
- ``traffic/<mix>.json``: the mix's parameters and the driver it uses,
  ``drivers/<driver>.py``;
- ``limits/<cell>.json``: the limits of the comparison that decides
  ``correct``, with the readings they were set from;
- ``metrics/<metric>.py``: one reader per per-layer metric;
- ``reference/``: the plain references (plain PyTorch and NumPy, nothing
  of the port).

Entry point: ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.
"""
