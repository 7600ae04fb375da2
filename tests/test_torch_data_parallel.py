"""The port's data-parallel trainers, training master, stats, multihost
helpers and distributed early stopping against the JAX package, in one
process (``tests/test_data_parallel.py``, ``test_training_master.py``,
``test_multihost_cpu.py``; the ranks of a ``'data'`` group are held to
these in ``test_torch_model_parallel.py``'s 4-process spawn).

Every JAX/port pair starts from the JAX net's params in f64. Bars: 1e-10
for SGD and Nesterovs steps (the f64 rounding of two reduction orders),
losses at 1e-10; the averaged LSTM in f32 at 1e-5 (JAX's averaging scan
carries the recurrent state in f32). Cases: ``ParallelWrapper`` over 8
devices equals the serial step and JAX's wrapper; a batch that does not
split raises; TBPTT (with a shorter backward length) and
``fit_batches`` through the wrapper; averaging at frequency 1 with SGD
equals the big-batch step, at frequency 3 JAX's averaging over 8
devices (and differs from gradient sync); masked sequences; each worker
draws its own dropout stream; ``balanced_splits``; the export round trip
and ``fit_paths``; the stats timeline; the evaluator's merge; the
multihost helpers in one process; distributed early stopping against
JAX's.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn import conf as jconf  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet  # noqa: E402
from deeplearning4j_tpu.parallel import data_parallel as jdp  # noqa: E402
from deeplearning4j_tpu.parallel import training_master as jtm  # noqa: E402

from deeplearning4j_tpu_torch.datasets.iterator import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as pconf  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.parallel import data_parallel as pdp  # noqa: E402
from deeplearning4j_tpu_torch.parallel import multihost as pmh  # noqa: E402
from deeplearning4j_tpu_torch.parallel import stats as pstats  # noqa: E402
from deeplearning4j_tpu_torch.parallel import training_master as ptm  # noqa: E402

TOL = 1e-10
_RNG = np.random.default_rng(7)
X = _RNG.standard_normal((144, 4))
Y = np.eye(3)[_RNG.integers(0, 3, 144)]


def _mlp(mod, updater="sgd", lr=0.1, dropout=None):
    dense = (mod.DenseLayer(n_in=4, n_out=8, activation="tanh")
             if dropout is None else
             mod.DenseLayer(n_in=4, n_out=8, activation="tanh",
                            dropout=dropout))
    return (mod.NeuralNetConfiguration.builder().seed(5).learning_rate(lr)
            .updater(updater).list().layer(0, dense)
            .layer(1, mod.OutputLayer(n_in=8, n_out=3, activation="softmax"))
            .build())


def _lstm(mod, fwd=4, back=4, tbptt=True):
    b = (mod.NeuralNetConfiguration.builder().seed(3).learning_rate(0.1)
         .weight_init("xavier").list()
         .layer(0, mod.GravesLSTM(n_in=5, n_out=6, activation="tanh"))
         .layer(1, mod.RnnOutputLayer(n_in=6, n_out=5, activation="softmax",
                                      loss_function="mcxent")))
    if tbptt:
        b = (b.backprop_type("truncated_bptt").t_bptt_forward_length(fwd)
             .t_bptt_backward_length(back))
    return b.build()


def _pair(conf_fn, input_shape=None, dtype=jnp.float64, **kw):
    """A JAX net and the port net with the same params, in f64 (or
    ``dtype``)."""
    jnet = JNet(conf_fn(jconf, **kw)).init(input_shape=input_shape)
    jnet.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype), jnet.params)
    jnet.updater_state = jnet.updater.init(jnet.params)
    pnet = MultiLayerNetwork(conf_fn(pconf, **kw), device="cpu").init(
        input_shape)
    pnet.params = [{n: torch.from_numpy(np.array(v)) for n, v in p.items()}
                   for p in jnet.params]
    pnet.updater_state = pnet.updater.init(pnet.params)
    return jnet, pnet


def _close(jnet, pnet, tol=TOL):
    ja = jax.tree_util.tree_leaves(jnet.params)
    pa = tree_leaves(pnet.params)
    assert len(ja) == len(pa)
    for a, b in zip(ja, pa):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= tol


def _seq(n=16, t=8, f=5, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, f, (n, t + 1))
    eye = np.eye(f)
    return eye[ids[:, :t]], eye[ids[:, 1:]]


# ---------------------------------------------------------------------------
# ParallelWrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("updater", ["sgd", "nesterovs"])
def test_parallel_wrapper_equals_serial_and_jax(updater):
    jnet, pnet = _pair(_mlp, updater=updater)
    serial = _pair(_mlp, updater=updater)[1]
    jpw = jdp.ParallelWrapper(jnet, num_devices=8)
    ppw = pdp.ParallelWrapper(pnet, num_devices=8, device="cpu")
    for _ in range(5):
        jl, pl = jpw.fit(X, Y), ppw.fit(X, Y)
        serial.fit(X, Y)
        assert abs(float(jl) - float(pl)) <= TOL
    _close(jnet, pnet)
    for a, b in zip(tree_leaves(pnet.params), tree_leaves(serial.params)):
        assert torch.equal(a, b)


def test_batch_not_divisible_raises():
    _, pnet = _pair(_mlp)
    with pytest.raises(ValueError, match="not divisible"):
        pdp.ParallelWrapper(pnet, num_devices=8, device="cpu").fit(
            X[:100], Y[:100])


@pytest.mark.parametrize("fwd,back", [(4, 4), (4, 2)])
def test_parallel_wrapper_tbptt_matches_jax(fwd, back):
    x, y = _seq()
    jnet, pnet = _pair(_lstm, input_shape=(1, 5), fwd=fwd, back=back)
    jpw = jdp.ParallelWrapper(jnet, num_devices=8)
    ppw = pdp.ParallelWrapper(pnet, num_devices=8, device="cpu")
    for _ in range(2):
        jpw.fit(x, y)
        ppw.fit(x, y)
    assert jnet.iteration == pnet.iteration == 4
    _close(jnet, pnet)


def test_parallel_wrapper_fit_batches_matches_jax():
    xs = np.stack([X[:48], X[48:96]])
    ys = np.stack([Y[:48], Y[48:96]])
    jnet, pnet = _pair(_mlp)
    jl = jdp.ParallelWrapper(jnet, num_devices=8).fit_batches(xs, ys)
    pl = pdp.ParallelWrapper(pnet, num_devices=8,
                             device="cpu").fit_batches(xs, ys)
    assert np.abs(np.asarray(jl, np.float64) - np.asarray(pl)).max() < 1e-6
    _close(jnet, pnet)


# ---------------------------------------------------------------------------
# parameter averaging
# ---------------------------------------------------------------------------


def test_averaging_freq1_sgd_equals_big_batch():
    _, pnet = _pair(_mlp)
    _, serial = _pair(_mlp)
    pdp.ParameterAveragingTrainer(pnet, num_workers=8, averaging_frequency=1,
                                  device="cpu").fit(X, Y)
    serial.fit(X, Y)
    for a, b in zip(tree_leaves(pnet.params), tree_leaves(serial.params)):
        assert (a - b).abs().max().item() <= TOL


def test_averaging_matches_jax_and_differs_from_grad_sync():
    jnet, pnet = _pair(_mlp)
    jtr = jdp.ParameterAveragingTrainer(jnet, num_workers=8,
                                        averaging_frequency=3)
    ptr = pdp.ParameterAveragingTrainer(pnet, num_workers=8,
                                        averaging_frequency=3, device="cpu")
    for _ in range(2):
        jl, pl = jtr.fit(X, Y), ptr.fit(X, Y)
        assert abs(float(jl) - float(pl)) <= TOL
    assert jnet.iteration == pnet.iteration == 6
    _close(jnet, pnet)
    _, sync = _pair(_mlp)
    for _ in range(2):
        for i in range(3):
            sync.fit(X[48 * i:48 * (i + 1)], Y[48 * i:48 * (i + 1)])
    diff = max((a - b).abs().max().item() for a, b in
               zip(tree_leaves(pnet.params), tree_leaves(sync.params)))
    assert diff > 1e-6


def test_averaging_masked_sequences_matches_jax():
    """Masks shard with the batch; the recurrent stream state is not
    averaged (whole sequences: standard backprop). In f32 at 1e-5: JAX's
    averaging scan carries the LSTM state in f32."""
    x, y = (a.astype(np.float32) for a in _seq(n=32, t=6))
    mask = np.ones((32, 6), np.float32)
    mask[:, 4:] = 0.0
    jnet, pnet = _pair(_lstm, input_shape=(1, 5), tbptt=False,
                       dtype=jnp.float32)
    jtr = jdp.ParameterAveragingTrainer(jnet, num_workers=8,
                                        averaging_frequency=2)
    ptr = pdp.ParameterAveragingTrainer(pnet, num_workers=8,
                                        averaging_frequency=2, device="cpu")
    for _ in range(2):
        jl = jtr.fit(x, y, mask=mask, label_mask=mask)
        pl = ptr.fit(x, y, mask=mask, label_mask=mask)
        assert abs(float(jl) - float(pl)) <= 1e-5
    _close(jnet, pnet, 1e-5)
    _, unmasked = _pair(_lstm, input_shape=(1, 5), tbptt=False,
                        dtype=jnp.float32)
    pdp.ParameterAveragingTrainer(unmasked, num_workers=8,
                                  averaging_frequency=2,
                                  device="cpu").fit(x, y)
    assert not torch.allclose(unmasked.params[0]["W"], pnet.params[0]["W"])


def test_workers_draw_distinct_dropout_streams():
    """Each averaging worker's dropout masks come from its own stream,
    the same stream for the same worker and step."""
    _, pnet = _pair(_mlp, dropout=0.5)

    def draw(worker):
        pnet._worker = worker
        try:
            g = pnet._dropout_gen(0, True, 0)
            return torch.rand(64, generator=g)
        finally:
            pnet._worker = None

    assert not torch.equal(draw(0), draw(1))
    assert torch.equal(draw(1), draw(1))
    assert not torch.equal(draw(None), draw(0))
    ptr = pdp.ParameterAveragingTrainer(pnet, num_workers=2,
                                        averaging_frequency=1, device="cpu")
    assert np.isfinite(float(ptr.fit(X[:32], Y[:32])))


# ---------------------------------------------------------------------------
# the training master, stats, evaluation, multihost, early stopping
# ---------------------------------------------------------------------------


def _datasets(mod_ds, n, batch, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4))
    y = np.eye(3)[rng.integers(0, 3, n)]
    return [mod_ds(x[i:i + batch], y[i:i + batch])
            for i in range(0, n, batch)]


@pytest.mark.parametrize("n,k", [(10, 3), (2, 5), (16, 4)])
def test_balanced_splits_match_jax(n, k):
    assert ptm.balanced_splits(n, k) == jtm.balanced_splits(n, k)


def test_master_matches_jax_and_export_round_trip(tmp_path):
    """One execute_training over 4 workers x 8 x 2 (two splits, the JAX
    master's shuffle) against JAX's; the export read back (through the
    native prefetch) fits to the same params as the direct fit."""
    from deeplearning4j_tpu.datasets.iterator import DataSet as JDataSet

    jnet, pnet = _pair(_mlp)
    jdata = _datasets(JDataSet, 128, 32)
    pdata = _datasets(DataSet, 128, 32)
    jm = jtm.ParameterAveragingTrainingMaster(
        num_workers=4, batch_size_per_worker=8, averaging_frequency=2,
        collect_training_stats=True)
    pm = ptm.ParameterAveragingTrainingMaster(
        num_workers=4, batch_size_per_worker=8, averaging_frequency=2,
        collect_training_stats=True, device="cpu")
    jm.execute_training(jnet, jdata)
    pm.execute_training(pnet, pdata)
    _close(jnet, pnet)
    summary = pm.get_training_stats().summary()
    assert summary["fit"]["count"] == 2 and "split" in summary
    paths = ptm.export_datasets(pdata, str(tmp_path / "exp"))
    assert len(paths) == 4
    back = list(ptm.load_exported_datasets(str(tmp_path / "exp")))
    for a, b in zip(back, pdata):
        assert np.array_equal(a.features, b.features)
    _, direct = _pair(_mlp)
    _, via = _pair(_mlp)
    mk = lambda: ptm.ParameterAveragingTrainingMaster(  # noqa: E731
        num_workers=4, batch_size_per_worker=8, averaging_frequency=2,
        device="cpu")
    ptm.SparkStyleNetwork(direct, mk()).fit(pdata)
    ptm.SparkStyleNetwork(via, mk()).fit_paths(sorted(paths))
    for a, b in zip(tree_leaves(direct.params), tree_leaves(via.params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="gs://"):
        ptm.export_datasets(pdata, "gs://bucket/x")
    with pytest.raises(ValueError, match="no exported"):
        list(ptm.load_exported_datasets(str(tmp_path / "none")))
    with pytest.raises(ValueError, match="averaging round"):
        ptm.ParameterAveragingTrainingMaster(
            num_workers=8, batch_size_per_worker=16, averaging_frequency=5,
            device="cpu").execute_training(pnet, pdata[:1])


def test_stats_timeline_and_time_sources(tmp_path):
    stats = pstats.TrainingStats()
    with stats.timed("fit", worker_id="w0", example_count=32):
        pass
    with stats.timed("aggregate", worker_id="w1"):
        pass
    stats.export_html(str(tmp_path / "t.html"))
    content = (tmp_path / "t.html").read_text()
    assert "timeline" in content and "fit" in content
    stats.export_json(str(tmp_path / "s.json"))
    assert "aggregate" in (tmp_path / "s.json").read_text()
    assert stats.summary()["fit"]["count"] == 1
    assert (pstats.NTPTimeSource(offset_millis=100_000).current_time_millis()
            > pstats.SystemClockTimeSource().current_time_millis() + 50_000)


def test_distributed_evaluator_merge_equals_serial():
    _, pnet = _pair(_mlp)
    data = _datasets(DataSet, 96, 16, seed=5)
    merged = ptm.DistributedEvaluator(num_shards=4).evaluate(pnet, data)
    serial = ptm.DistributedEvaluator(num_shards=1).evaluate(pnet, data)
    assert merged.accuracy() == serial.accuracy()
    assert merged.f1() == serial.f1()


def test_multihost_single_process_and_env(monkeypatch):
    assert pmh.initialize_multihost(pmh.MultiHostConfig()) is False
    info = pmh.process_info()
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert pmh.local_batch_slice(64) == slice(0, 64)
    with pytest.raises(ValueError, match="not divisible"):
        pmh.local_batch_slice(10, process_count=4, process_index=1)
    assert pmh.local_batch_slice(8, 4, 3) == slice(6, 8)
    monkeypatch.setenv("DL4J_TPU_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("DL4J_TPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("DL4J_TPU_PROCESS_ID", "2")
    cfg = pmh.MultiHostConfig.from_env()
    assert cfg.is_configured() and cfg.coordinator_address == "10.0.0.1:1234"
    assert cfg.num_processes == 4 and cfg.process_id == 2
    assert pmh.is_primary() is False
    assert torch.equal(pmh.put_batch(X[:4], device="cpu"),
                       torch.from_numpy(X[:4]))


def test_distributed_early_stopping_matches_jax():
    """MaxEpochs(2) over the averaging master: each epoch one round, the
    same epochs and scores as JAX's trainer."""
    from deeplearning4j_tpu.datasets.iterator import DataSet as JDataSet
    from deeplearning4j_tpu.earlystopping.config import (
        EarlyStoppingConfiguration as JCfg,
    )
    from deeplearning4j_tpu.earlystopping.distributed import (
        DistributedEarlyStoppingTrainer as JES,
    )
    from deeplearning4j_tpu.earlystopping.terminations import (
        MaxEpochsTerminationCondition as JMax,
    )

    from deeplearning4j_tpu_torch.earlystopping import (
        EarlyStoppingConfiguration,
        MaxEpochsTerminationCondition,
    )
    from deeplearning4j_tpu_torch.earlystopping.distributed import (
        DistributedEarlyStoppingTrainer,
    )

    jnet, pnet = _pair(_mlp)
    mk = lambda mod: mod.ParameterAveragingTrainingMaster(  # noqa: E731
        num_workers=2, batch_size_per_worker=8, averaging_frequency=1,
        **({} if mod is jtm else {"device": "cpu"}))
    jr = JES(JCfg(epoch_terminations=[JMax(2)]), mk(jtm), jnet,
             _datasets(JDataSet, 32, 16)).fit(max_epochs=50)
    pr = DistributedEarlyStoppingTrainer(
        EarlyStoppingConfiguration(
            epoch_terminations=[MaxEpochsTerminationCondition(2)]),
        mk(ptm), pnet, _datasets(DataSet, 32, 16),
        device="cpu").fit(max_epochs=50)
    assert pr.total_epochs == jr.total_epochs == 2
    assert pr.best_model is not None
    assert abs(pr.best_model_score - jr.best_model_score) <= TOL
    _close(jnet, pnet)
