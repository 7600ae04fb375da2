"""The distributed-training control plane (counterpart:
``deeplearning4j_tpu/parallel/training_master.py`` — ``WorkerConfiguration``,
``Repartition``, ``balanced_splits`` :65, ``TrainingMaster`` :77,
``export_datasets`` :92, ``load_exported_datasets`` :142,
``ParameterAveragingTrainingMaster`` :187 with ``execute_training`` :302
and ``execute_training_paths`` :351,
``ElasticParameterAveragingTrainingMaster`` :360 over
``parallel/fleet.py``, ``DistributedEvaluator`` :429 and
``SparkStyleNetwork`` :468).

The host half of the reference's Spark training: data splitting (each
split is workers x batch x frequency examples, shuffled per call under
``Repartition.ALWAYS``), bounded retries, stats, the evaluation merge.
Each split is one round of ``parallel/data_parallel
.ParameterAveragingTrainer`` (the n workers in this process, or one per
rank of a ``'data'`` group). Exports are local ``.npz`` files read back
through the port's ``native.iter_npz``; a ``gs://`` location raises (the
JAX package stages those through ``provision/``, which the port does not
have).
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass
from typing import Iterable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterator import DataSet
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    ParameterAveragingTrainer,
)
from deeplearning4j_tpu_torch.parallel.stats import TrainingStats

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _refuse_gs(path) -> None:
    if isinstance(path, str) and path.startswith("gs://"):
        raise ValueError(
            f"{path!r}: the port reads and writes local paths only (the JAX "
            "package stages gs:// through provision/, which is not ported)")


@dataclass
class WorkerConfiguration:
    """Reference api/WorkerConfiguration.java."""

    batch_size_per_worker: int = 16
    averaging_frequency: int = 5
    prefetch_num_batches: int = 2
    collect_training_stats: bool = False


class Repartition:
    """Reference api/Repartition enum."""

    ALWAYS = "always"
    NEVER = "never"
    NUM_PARTITIONS_WORKERS_DIFFERS = "num_partitions_workers_differs"


def balanced_splits(n: int, k: int) -> List[slice]:
    """Exact balanced partitioning (reference BalancedPartitioner +
    AssignIndexFunction semantics): first n%k parts get one extra element."""
    base, extra = divmod(n, k)
    out, start = [], 0
    for i in range(k):
        size = base + (1 if i < extra else 0)
        out.append(slice(start, start + size))
        start += size
    return out


class TrainingMaster:
    """Abstract contract (TrainingMaster.java): executeTraining + stats."""

    def execute_training(self, net, iterator) -> None:
        raise NotImplementedError

    def get_training_stats(self) -> Optional[TrainingStats]:
        return None


# -- exported-dataset plane (RDDTrainingApproach.Export role) ---------------

_EXPORT_PREFIX = "dataset_"


def export_datasets(iterator_or_datasets, dest: str,
                    prefix: str = _EXPORT_PREFIX) -> List[str]:
    """Each DataSet minibatch to its own ``{prefix}{i:05d}.npz`` under the
    local directory ``dest`` (the reference's export plumbing, read back
    by :func:`load_exported_datasets`); returns the paths."""
    import os

    _refuse_gs(dest)
    datasets = (list(iterator_or_datasets)
                if not isinstance(iterator_or_datasets, (list, tuple))
                else iterator_or_datasets)
    os.makedirs(dest, exist_ok=True)
    paths = []
    for i, ds in enumerate(datasets):
        arrays = {"features": _host(ds.features),
                  "labels": _host(ds.labels)}
        if getattr(ds, "features_mask", None) is not None:
            arrays["features_mask"] = _host(ds.features_mask)
        if getattr(ds, "labels_mask", None) is not None:
            arrays["labels_mask"] = _host(ds.labels_mask)
        local = os.path.join(dest, f"{prefix}{i:05d}.npz")
        np.savez(local, **arrays)
        paths.append(local)
    return paths


def _host(a) -> np.ndarray:
    import torch

    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def load_exported_datasets(path,
                           prefix: str = _EXPORT_PREFIX) -> Iterable[DataSet]:
    """DataSets back from an export: a local directory (files matching
    ``prefix``, in name order) or an explicit list of files, parsed ahead
    by the port's native prefetch thread (``native.iter_npz``)."""
    import glob
    import os

    if isinstance(path, (list, tuple)):
        files = sorted(path)
        for f in files:
            _refuse_gs(f)
    else:
        _refuse_gs(path)
        files = sorted(glob.glob(os.path.join(path, f"{prefix}*.npz")))
    if not files:
        raise ValueError(f"no exported datasets under {path!r}")
    from deeplearning4j_tpu_torch.native import iter_npz

    for z in iter_npz(files):
        yield DataSet(z["features"], z["labels"], z.get("features_mask"),
                      z.get("labels_mask"))


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Host control plane over ``ParameterAveragingTrainer``: each split
    is one averaging round. ``group``: the ``'data'`` group, one worker a
    rank (every rank passes the same data); otherwise ``num_workers`` run
    in this process. ``device`` is where the nets live: the card unless
    the caller passes ``device="cpu"``."""

    def __init__(
        self,
        num_workers: Optional[int] = None,
        batch_size_per_worker: int = 16,
        averaging_frequency: int = 5,
        save_updater: bool = True,
        repartition: str = Repartition.ALWAYS,
        collect_training_stats: bool = False,
        max_retries: int = 2,
        rng_seed: int = 12345,
        group=None,
        device=None,
    ):
        from deeplearning4j_tpu_torch.ops.device import resolve_device

        self.device = resolve_device(device)
        self.group = group
        # worker count: the group's size, else given, else the devices
        self._num_workers = int(num_workers) if num_workers else None
        self.batch_size_per_worker = batch_size_per_worker
        self.averaging_frequency = max(1, averaging_frequency)
        self.save_updater = save_updater
        self.repartition = repartition
        self.collect_training_stats = collect_training_stats
        self.max_retries = max_retries
        self.rng_seed = rng_seed
        self.stats = TrainingStats() if collect_training_stats else None
        self._trainer = None  # ParameterAveragingTrainer or the fleet
        self._trainer_net = None
        self._round = 0

    @property
    def num_workers(self) -> int:
        if self._num_workers is None:
            if self.group is not None:
                from deeplearning4j_tpu_torch.parallel.mesh import group_size

                self._num_workers = group_size(self.group)
            else:
                import torch

                self._num_workers = max(1, torch.cuda.device_count()
                                        if self.device.type == "cuda" else 1)
        return self._num_workers

    @num_workers.setter
    def num_workers(self, value: int) -> None:
        self._num_workers = int(value)

    # -- data plane helpers -----------------------------------------------
    def _examples_per_split(self) -> int:
        # reference :148: one split feeds every worker `freq` minibatches
        return (self.num_workers * self.batch_size_per_worker
                * self.averaging_frequency)

    def _collect(self, iterator) -> List[DataSet]:
        if isinstance(iterator, (list, tuple)):
            return list(iterator)
        out = list(iterator)
        if hasattr(iterator, "reset"):
            iterator.reset()
        return out

    def _splits(self, datasets: List[DataSet]):
        """Concatenate and re-split so each split is exactly
        workers x batch x freq examples (repartition=Always; the reference's
        Balanced repartition becomes an exact reshape here). Features/labels
        may be per-component LISTS (multi-input/multi-output
        ComputationGraph — the reference's MultiDataSet); every component is
        permuted and sliced with the same index set."""

        def cat(get):
            first = get(datasets[0])
            if isinstance(first, (list, tuple)):
                return [
                    np.concatenate([_host(get(d)[i]) for d in datasets])
                    for i in range(len(first))
                ]
            return np.concatenate([_host(get(d)) for d in datasets])

        # DataSet carries arrays (or component lists); MultiDataSet carries
        # features_list/labels_list — normalize the accessors
        def accessor(multi_attr, single_attr):
            def get(d):
                comp = getattr(d, multi_attr, None)
                if comp is not None:
                    if not comp:
                        raise ValueError(
                            f"{type(d).__name__}.{multi_attr} is empty")
                    return comp
                return getattr(d, single_attr)

            return get

        x = cat(accessor("features_list", "features"))
        y = cat(accessor("labels_list", "labels"))
        take = lambda comp, idx: (
            [c[idx] for c in comp] if isinstance(comp, list) else comp[idx]
        )
        n = (x[0] if isinstance(x, list) else x).shape[0]
        if self.repartition == Repartition.ALWAYS:
            # vary the shuffle per call (the reference repartitions each fit)
            rng = np.random.default_rng(self.rng_seed + self._round)
            self._round += 1
            order = rng.permutation(n)
            x, y = take(x, order), take(y, order)
        per = self._examples_per_split()
        n_full = n // per
        dropped = n - n_full * per
        if dropped:
            # whole averaging rounds only; the shuffle rotates which
            # examples land in the tail across rounds
            logger.warning(
                "parameter averaging: dropping %d tail examples "
                "(< one %d-example round)", dropped, per,
            )
        for s in range(n_full):
            sl = slice(s * per, (s + 1) * per)
            yield take(x, sl), take(y, sl)

    # -- TrainingMaster contract ------------------------------------------
    def execute_training(self, net, iterator) -> None:
        """fit(JavaRDD<DataSet>) analog (SparkDl4jMultiLayer.fit:194-230 →
        executeTraining:163; SparkComputationGraph.fit:68 for graphs): per
        split, one averaging round on the mesh. Drives BOTH containers —
        the trainer dispatches on MultiLayerNetwork vs ComputationGraph."""
        if self._trainer is None or self._trainer_net is not net:
            self._trainer = ParameterAveragingTrainer(
                net,
                num_workers=self.num_workers,
                averaging_frequency=self.averaging_frequency,
                save_updater=self.save_updater,
                group=self.group,
                device=self.device,
            )
            self._trainer_net = net
        datasets = self._collect(iterator)
        stats = self.stats
        with stats.timed("split") if stats else contextlib.nullcontext():
            splits = list(self._splits(datasets))
        if not splits:
            raise ValueError(
                f"not enough examples for one averaging round "
                f"(need {self._examples_per_split()})"
            )
        for x, y in splits:
            # x may be a per-component LIST (multi-input graph): the example
            # count is the leading dim of a component, not the list length
            n_examples = (x[0] if isinstance(x, list) else x).shape[0]
            attempt = 0
            while True:
                try:
                    t0 = (stats.time_source.current_time_millis()
                          if stats else 0)
                    p0 = time.perf_counter()
                    self._trainer.fit(x, y)
                    if stats:  # record successful attempts only
                        stats.record(
                            "fit", t0, (time.perf_counter() - p0) * 1000.0,
                            example_count=n_examples,
                        )
                    break
                except Exception:
                    # Spark retries failed tasks natively (SURVEY.md section 5
                    # failure detection); parameter averaging is idempotent
                    # per split, so a bounded retry reproduces that behavior.
                    attempt += 1
                    if attempt > self.max_retries:
                        raise

    def get_training_stats(self) -> Optional[TrainingStats]:
        return self.stats

    def execute_training_paths(self, net, path) -> None:
        """Fit from a previously exported location (the reference's
        executeTraining(JavaPairRDD<String, PortableDataStream>) branch,
        ParameterAveragingTrainingMaster.java:189-210, fed by
        SparkDl4jMultiLayer.fit(String path) :217): deserialize the
        exported DataSets, then run the same split/average loop."""
        self.execute_training(net, load_exported_datasets(path))


class ElasticParameterAveragingTrainingMaster(ParameterAveragingTrainingMaster):
    """The averaging master over the elastic fleet: the same
    split/average control plane, each split one round of
    ``parallel/fleet.ElasticParameterAveragingTrainer`` (workers join and
    leave mid-run, every round re-forms over the live membership, a dead
    member's in-flight work is reclaimed). ``num_workers`` sizes the
    splits (workers x batch x freq examples) and the initial in-process
    fleet. Pick the split divisible by every membership size the run may
    pass through: an indivisible round raises."""

    def __init__(self, *args, fleet_kwargs: Optional[dict] = None, **kw):
        super().__init__(*args, **kw)
        self.fleet_kwargs = dict(fleet_kwargs or {})

    def execute_training(self, net, iterator) -> None:
        from deeplearning4j_tpu_torch.parallel.fleet import (
            ElasticParameterAveragingTrainer,
        )

        if self._trainer is None or self._trainer_net is not net:
            if self._trainer is not None:
                self._trainer.close()  # its workers must not outlive it
            self._trainer = ElasticParameterAveragingTrainer(
                net, num_workers=self.num_workers,
                averaging_frequency=self.averaging_frequency,
                save_updater=self.save_updater, device=self.device,
                **self.fleet_kwargs)
            self._trainer_net = net
        # the parent's split/retry/stats loop drives self._trainer.fit
        super().execute_training(net, iterator)

    @property
    def fleet(self):
        """The live ElasticParameterAveragingTrainer (None before the
        first execute_training): the membership surface."""
        return self._trainer

    def close(self) -> None:
        """Stop the fleet this master spawned (worker threads, any
        tracker server)."""
        if self._trainer is not None:
            self._trainer.close()
            self._trainer = None
            self._trainer_net = None

    def __enter__(self) -> "ElasticParameterAveragingTrainingMaster":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class DistributedEvaluator:
    """Map-reduce evaluation (EvaluateFlatMapFunction +
    EvaluationReduceFunction): evaluate shards independently, merge."""

    def __init__(self, num_shards: Optional[int] = None):
        self._num_shards = int(num_shards) if num_shards else None

    @property
    def num_shards(self) -> int:
        if self._num_shards is None:
            import torch

            self._num_shards = max(1, torch.cuda.device_count())
        return self._num_shards

    @num_shards.setter
    def num_shards(self, value: int) -> None:
        self._num_shards = int(value)

    def evaluate(self, net, datasets: Iterable[DataSet]) -> Evaluation:
        datasets = list(datasets)
        shards = balanced_splits(len(datasets), self.num_shards)
        partials: List[Evaluation] = []
        for sl in shards:
            ev = Evaluation()
            for ds in datasets[sl]:
                out = net.output(ds.features)
                out0 = out[0] if isinstance(out, (list, tuple)) else out
                ev.eval(_host(ds.labels), _host(out0),
                        mask=None if ds.labels_mask is None
                        else _host(ds.labels_mask))
            partials.append(ev)
        merged = partials[0]
        for ev in partials[1:]:
            merged.merge(ev)
        return merged


class SparkStyleNetwork:
    """User-facing wrapper pairing a net with a TrainingMaster
    (SparkDl4jMultiLayer / SparkComputationGraph role — both containers
    train under the averaging master)."""

    def __init__(self, net, training_master: TrainingMaster):
        self.net = net
        self.training_master = training_master

    def fit(self, iterator_or_datasets) -> "SparkStyleNetwork":
        self.training_master.execute_training(self.net, iterator_or_datasets)
        return self

    def fit_paths(self, path) -> "SparkStyleNetwork":
        """Fit from exported DataSet files: a local directory or a file
        list (SparkDl4jMultiLayer.fit(String path) :217)."""
        self.training_master.execute_training_paths(self.net, path)
        return self

    def evaluate(self, datasets) -> Evaluation:
        return DistributedEvaluator().evaluate(self.net, datasets)

    def score_examples(self, datasets) -> np.ndarray:
        """Per-example scores (SparkDl4jMultiLayer.scoreExamples): one loss
        value per example, concatenated over all datasets, by scoring
        batch-1 slices."""
        scores = []
        for ds in datasets:
            f = _host(ds.features)
            l = _host(ds.labels)
            for i in range(f.shape[0]):
                scores.append(self.net.score(f[i : i + 1], l[i : i + 1]))
        return np.asarray(scores)
