"""Score calculators (counterpart:
``deeplearning4j_tpu/earlystopping/scorecalc.py``; reference
earlystopping/scorecalc/DataSetLossCalculator.java): the average loss
over a held-out iterator, the early-stopping signal."""

from __future__ import annotations


class DataSetLossCalculator:
    """Average loss over all batches of a validation iterator (reference
    DataSetLossCalculator.java — average=True semantics)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        total = 0.0
        count = 0
        from deeplearning4j_tpu_torch.earlystopping.trainer import score_dataset

        for ds in self.iterator:
            n = ds.num_examples()
            s = score_dataset(net, ds)
            total += s * (n if self.average else 1.0)
            count += n
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        if count == 0:
            return float("nan")
        return total / count if self.average else total
