"""The port's training runtime (``deeplearning4j_tpu_torch/resilience/``,
``utils/serialization.ModelSerializer.load_into``) against the JAX
package's: checkpoint directories, manifests and zips read both ways;
retention, the bit-flip and truncation fallbacks and the busy-writer
skip; an async save equal to a sync one when a step follows the
snapshot; kill at step k and resume bit-equal to an uninterrupted run
in f64 (a MultiLayerNetwork and a ComputationGraph); the port resuming
a JAX-written checkpoint and ending at JAX's uninterrupted params within
1e-10; a real SIGTERM in a child process; the retry backoff and the
LowPrecChaos scale sequence equal to JAX's."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.datasets import iterator as jit  # noqa: E402
from deeplearning4j_tpu.nn import conf as jconf  # noqa: E402
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet  # noqa: E402
from deeplearning4j_tpu import resilience as jres  # noqa: E402
from deeplearning4j_tpu.utils.serialization import (  # noqa: E402
    ModelSerializer as JSer,
)

from deeplearning4j_tpu_torch.datasets import iterator as pit  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as pconf  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves, tree_map  # noqa: E402
from deeplearning4j_tpu_torch import resilience as pres  # noqa: E402
from deeplearning4j_tpu_torch.resilience import chaos as pchaos  # noqa: E402
from deeplearning4j_tpu_torch.utils.serialization import (  # noqa: E402
    ModelSerializer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RNG = np.random.default_rng(0)
X = _RNG.standard_normal((48, 6))
Y = np.eye(3)[_RNG.integers(0, 3, 48)]
TOL_F64 = 1e-10


def _conf(mod, graph=False, updater="adam"):
    b = mod.NeuralNetConfiguration.builder().seed(7).learning_rate(0.05)
    b = b.updater(updater)
    dense = mod.DenseLayer(n_in=6, n_out=8, activation="tanh")
    out = mod.OutputLayer(n_in=8, n_out=3, activation="softmax",
                          loss_function="mcxent")
    if graph:
        return (b.graph_builder().add_inputs("in").add_layer("d", dense, "in")
                .add_layer("out", out, "d").set_outputs("out").build())
    return b.list().layer(0, dense).layer(1, out).build()


def _f64(net):
    """The port net's params, states and a fresh updater state in f64."""
    net.params = tree_map(lambda t: t.double(), net.params)
    net.states = tree_map(lambda t: t.double(), net.states)
    net.updater_state = net.updater.init(net.params)
    return net


def mln64(updater="adam"):
    return _f64(MultiLayerNetwork(_conf(pconf, updater=updater),
                                  device="cpu").init())


def cg64():
    return _f64(ComputationGraph(_conf(pconf, graph=True),
                                 device="cpu").init())


def mln32():
    return MultiLayerNetwork(_conf(pconf), device="cpu").init()


def _it(dtype=np.float64, batch=8):
    return pit.ListDataSetIterator(X.astype(dtype), Y.astype(dtype), batch)


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _trainer(net, mgr=None, **kw):
    return pres.ResilientTrainer(net, mgr, device="cpu", **kw)


# ------------------------------------------------------- formats both ways

class TestFormatsBothWays:
    def test_port_directory_reads_in_jax(self, tmp_path):
        net = mln32()
        _trainer(net).fit(_it(np.float32), num_epochs=1)
        mgr = pres.CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(net, step=6, epoch=0, iterator_state={"cursor": 6})
        jm = jres.CheckpointManager(str(tmp_path))
        path, manifest = jm.latest_intact()
        assert manifest["step"] == 6 and manifest["iterator_state"] == {
            "cursor": 6}
        assert manifest["model_class"] == "MultiLayerNetwork"
        assert manifest["files"] == mgr.read_manifest(path)["files"]
        jnet = JSer.restore(os.path.join(path, "model.zip"))
        assert jnet.iteration == net.iteration == 6
        for a, b in zip(jax.tree_util.tree_leaves(jnet.params),
                        tree_leaves(net.params)):
            assert np.array_equal(np.asarray(a), b.numpy())
        fresh = JNet(_conf(jconf))
        info = jm.restore(path, fresh)
        assert info["step"] == 6 and info["iterator_state"] == {"cursor": 6}

    @pytest.mark.parametrize("graph", [False, True])
    def test_jax_directory_reads_in_the_port(self, tmp_path, graph):
        jnet = (JGraph if graph else JNet)(_conf(jconf, graph)).init()
        jres.ResilientTrainer(jnet).fit(
            jit.ListDataSetIterator(X.astype(np.float32),
                                    Y.astype(np.float32), 8))
        jm = jres.CheckpointManager(str(tmp_path), async_save=False)
        jm.save(jnet, step=6, epoch=1, iterator_state={"cursor": 2})
        mgr = pres.CheckpointManager(str(tmp_path))
        path, _ = mgr.latest_intact()
        net = (ComputationGraph(_conf(pconf, True), device="cpu") if graph
               else MultiLayerNetwork(_conf(pconf), device="cpu"))
        info = mgr.restore(path, net)
        assert info == {"step": 6, "epoch": 1,
                        "iterator_state": {"cursor": 2}, "path": path}
        assert net.iteration == jnet.iteration
        for a, b in zip(jax.tree_util.tree_leaves(jnet.params),
                        tree_leaves(net.params)):
            assert np.array_equal(np.asarray(a), b.numpy())
        for a, b in zip(jax.tree_util.tree_leaves(jnet.updater_state),
                        tree_leaves(net.updater_state)):
            assert np.array_equal(np.asarray(a), b.numpy())

    def test_load_into_refuses_the_wrong_class(self, tmp_path):
        p = str(tmp_path / "m.zip")
        ModelSerializer.write_model(mln32(), p)
        with pytest.raises(ValueError, match="MultiLayerNetwork"):
            ModelSerializer.load_into(
                ComputationGraph(_conf(pconf, True), device="cpu"), p)
        # the sharded backend is ported (test_torch_sharded_checkpoint.py);
        # a backend of neither package raises
        with pytest.raises(ValueError, match="unknown checkpoint backend"):
            pres.CheckpointManager(str(tmp_path / "s"), backend="orbax")
        assert pres.CheckpointManager(str(tmp_path / "s"),
                                      backend="sharded").backend == "sharded"


# ----------------------------------------------------------- the manager

class TestManager:
    def test_retention_keep_last_and_every(self, tmp_path):
        mgr = pres.CheckpointManager(str(tmp_path), keep_last=2,
                                     keep_every=4, async_save=False)
        net = mln32()
        for s in range(1, 10):
            mgr.save(net, step=s)
        assert [s for s, _ in mgr.checkpoints()] == [4, 8, 9]
        assert mgr.stats["pruned"] == 6

    @pytest.mark.parametrize("mode", ["bitflip", "truncate"])
    def test_corrupt_newest_falls_back(self, tmp_path, mode, caplog):
        mgr = pres.CheckpointManager(str(tmp_path), keep_last=3,
                                     async_save=False)
        net = mln32()
        for s in (1, 2, 3):
            mgr.save(net, step=s)
        target = os.path.join(mgr.checkpoints()[-1][1], "model.zip")
        if mode == "bitflip":
            pchaos.bitflip_file(target)
        else:
            pchaos.truncate_file(target)
        ok, reason = mgr.verify(mgr.checkpoints()[-1][1])
        assert not ok and ("sha256" in reason or "size" in reason)
        path, manifest = mgr.latest_intact()
        assert manifest["step"] == 2 and "corrupt" in caplog.text
        # the JAX manager falls back the same way
        assert jres.CheckpointManager(str(tmp_path)).latest_intact()[0] \
            == path
        with pytest.raises(pres.CheckpointCorrupt):
            mgr.restore(mgr.checkpoints()[-1][1], mln32())

    def test_skip_while_the_writer_is_busy(self, tmp_path, monkeypatch):
        mgr = pres.CheckpointManager(str(tmp_path), async_save=True)
        gate = threading.Event()
        real = mgr._write

        def slow(job):
            gate.wait(10)
            real(job)

        monkeypatch.setattr(mgr, "_write", slow)
        net = mln32()
        for s in (1, 2, 3, 4):
            mgr.save(net, step=s)
        assert mgr.stats["skipped_busy"] >= 1
        gate.set()
        mgr.flush()
        mgr.close()
        assert mgr.stats["saves"] + mgr.stats["skipped_busy"] == 4

    def test_async_equals_sync_with_a_step_after_the_snapshot(self, tmp_path):
        net = mln64()
        x, y = X[:8], Y[:8]
        net.fit(x, y)
        want = tree_map(torch.clone, net.params)
        a = pres.CheckpointManager(str(tmp_path / "a"), async_save=True)
        s = pres.CheckpointManager(str(tmp_path / "s"), async_save=False)
        gate = threading.Event()
        real = a._write
        a._write = lambda job: (gate.wait(10), real(job))
        a.save(net, step=1)
        s.save(net, step=1)
        for _ in range(3):  # the updater writes the params in place
            net.fit(x, y)
        assert not _leaves_equal(net.params, want)
        gate.set()
        a.flush()
        for mgr in (a, s):
            back = mln64()
            mgr.restore_latest(back)
            assert _leaves_equal(back.params, want)
        pa = os.path.join(a.checkpoints()[0][1], "model.zip")
        ps = os.path.join(s.checkpoints()[0][1], "model.zip")
        import zipfile

        with zipfile.ZipFile(pa) as za, zipfile.ZipFile(ps) as zs:
            for name in ("coefficients.npz", "updater.npz", "state.npz"):
                assert za.read(name) == zs.read(name), name
        a.close()


# ------------------------------------------------------------ exact resume

def _resume(builder, tmp, kill_at=7, epochs=3, iterator=_it):
    base = _trainer(builder())
    base.fit(iterator(), num_epochs=epochs)
    mgr = pres.CheckpointManager(tmp, every_steps=4, keep_last=3)
    killed = _trainer(builder(), mgr, chaos=pres.ChaosMonkey(
        pres.ChaosConfig(kill_at_step=kill_at)))
    with pytest.raises(pres.InjectedKill):
        killed.fit(iterator(), num_epochs=epochs)
    mgr.close()
    mgr2 = pres.CheckpointManager(tmp, every_steps=4, keep_last=3)
    resumed = _trainer(builder(), mgr2)
    resumed.fit(iterator(), num_epochs=epochs)
    mgr2.close()
    return base, killed, resumed


@pytest.mark.parametrize("builder", [mln64, cg64], ids=["mln", "graph"])
def test_kill_and_resume_is_bit_equal_in_f64(tmp_path, builder):
    base, killed, resumed = _resume(builder, str(tmp_path))
    assert resumed.resumed_step == 4 and resumed.step == base.step == 18
    assert killed.losses[:4] + resumed.losses == base.losses
    assert _leaves_equal(base.net.params, resumed.net.params)
    assert _leaves_equal(base.net.updater_state, resumed.net.updater_state)
    assert tree_leaves(resumed.net.params)[0].dtype == torch.float64
    assert resumed.resilience_stats["resumes"] == 1


def test_resume_through_the_pipeline_and_async_iterator(tmp_path):
    from deeplearning4j_tpu_torch.etl.pipeline import InputPipeline

    def piped():
        return InputPipeline(_it(), workers=2, prefetch=3, device="cpu",
                             shard=None)

    base, killed, resumed = _resume(mln64, str(tmp_path / "p"),
                                    iterator=piped)
    assert _leaves_equal(base.net.params, resumed.net.params)

    def asynced():
        return pit.AsyncDataSetIterator(_it(), queue_size=4, device="cpu")

    base, killed, resumed = _resume(mln64, str(tmp_path / "a"),
                                    iterator=asynced)
    assert killed.losses[:4] + resumed.losses == base.losses
    assert _leaves_equal(base.net.params, resumed.net.params)


def _jax_f64_net():
    # Nesterov momentum: the JAX package's Adam keeps f32 pieces that part
    # the two packages' f64 runs by ~1e-9 a step, past the 1e-10 bar
    jnet = JNet(_conf(jconf, updater="nesterovs")).init()
    jnet.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), jnet.params)
    jnet.updater_state = jnet.updater.init(jnet.params)
    return jnet


def test_the_port_resumes_a_jax_checkpoint(tmp_path):
    jit_ = lambda: jit.ListDataSetIterator(X, Y, 8)  # noqa: E731
    base = jres.ResilientTrainer(_jax_f64_net())
    base.fit(jit_(), num_epochs=3)
    mgr = jres.CheckpointManager(str(tmp_path), every_steps=4, keep_last=3)
    killed = jres.ResilientTrainer(_jax_f64_net(), mgr, chaos=jres.ChaosMonkey(
        jres.ChaosConfig(kill_at_step=10)))
    with pytest.raises(jres.InjectedKill):
        killed.fit(jit_(), num_epochs=3)
    mgr.close()
    pm = pres.CheckpointManager(str(tmp_path), every_steps=4, keep_last=3)
    resumed = _trainer(mln64("nesterovs"), pm)
    resumed.fit(_it(), num_epochs=3)
    pm.close()
    assert resumed.resumed_step == 8 and resumed.step == base.step == 18
    for a, b in zip(jax.tree_util.tree_leaves(base.net.params),
                    tree_leaves(resumed.net.params)):
        assert b.dtype == torch.float64
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=TOL_F64)
    np.testing.assert_allclose(resumed.losses, base.losses[8:], rtol=0,
                               atol=TOL_F64)


SIGTERM_CHILD = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np
sys.path.insert(0, {tests!r})
import test_torch_resilience as t
from deeplearning4j_tpu_torch import resilience as pres
mgr = pres.CheckpointManager({ckpt!r}, every_steps=4, keep_last=3)
tr = pres.ResilientTrainer(t.mln64(), mgr, device="cpu",
    chaos=pres.ChaosMonkey(pres.ChaosConfig(kill_at_step=6,
                                            kill_mode="sigterm")))
try:
    tr.fit(t._it(), num_epochs=3)
except pres.Preempted as e:
    print("PREEMPTED", e.step, tr.resilience_stats["preemptions"])
    sys.exit(3)
sys.exit(0)
"""


def test_sigterm_in_a_child_then_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    code = SIGTERM_CHILD.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                                ckpt=ckpt)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert r.returncode == 3, r.stdout + r.stderr
    assert "PREEMPTED 6 1" in r.stdout
    mgr = pres.CheckpointManager(ckpt, every_steps=4, keep_last=3)
    assert [s for s, _ in mgr.checkpoints()] == [4, 6]
    resumed = _trainer(mln64(), mgr)
    resumed.fit(_it(), num_epochs=3)
    mgr.close()
    base = _trainer(mln64())
    base.fit(_it(), num_epochs=3)
    assert resumed.resumed_step == 6
    assert resumed.losses == base.losses[6:]
    assert _leaves_equal(base.net.params, resumed.net.params)


def test_sigterm_handler_is_restored_and_retry_counts():
    import signal

    before = signal.getsignal(signal.SIGTERM)
    tr = _trainer(mln64(), max_step_retries=2, retry_backoff_s=0.001,
                  chaos=pres.ChaosMonkey(pres.ChaosConfig(
                      transient_error_at_step=3, transient_error_count=2)))
    tr.fit(_it(), num_epochs=1)
    assert signal.getsignal(signal.SIGTERM) is before
    assert tr.resilience_stats["retries"] == 2 and tr.step == 6
    tr2 = _trainer(mln64(), max_step_retries=0, chaos=pres.ChaosMonkey(
        pres.ChaosConfig(transient_error_at_step=2)))
    with pytest.raises(pres.TransientDeviceError):
        tr2.fit(_it(), num_epochs=1)


@pytest.mark.parametrize("salt", [0, 5, 12345])
def test_backoff_sequence_equals_jax(salt):
    jt = jres.ResilientTrainer(JNet(_conf(jconf)), retry_salt=salt,
                               retry_backoff_s=0.01, retry_backoff_max_s=0.3)
    pt = _trainer(mln32(), retry_salt=salt, retry_backoff_s=0.01,
                  retry_backoff_max_s=0.3)
    for step in (0, 3, 17):
        jt.step = pt.step = step
        seq = [pt._retry_backoff(a) for a in range(1, 8)]
        assert seq == [jt._retry_backoff(a) for a in range(1, 8)]
        assert max(seq) <= 0.3 * (1 + pt.retry_jitter)


def test_lowprec_chaos_scale_sequence_equals_jax(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_BF16", "1")
    monkeypatch.setenv("DL4J_TPU_LOSS_SCALE", "8:2")
    cfg = dict(overflow_at_step=3, count=2, mode="nan")
    jc = jres.LowPrecChaos(jres.LowPrecChaosConfig(**cfg))
    pc = pchaos.LowPrecChaos(cfg)
    jnet = JNet(_conf(jconf)).init()
    pnet = mln32()
    pnet.params = [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
                   for p in jnet.params]
    pnet.updater_state = pnet.updater.init(pnet.params)
    x, y = X[:8].astype(np.float32), Y[:8].astype(np.float32)
    seq_j, seq_p = [], []
    for step in range(1, 8):
        jnet.fit(jnp.asarray(jc.poison(step, x)), jnp.asarray(y))
        pnet.fit(pc.poison(step, x), y)
        t = lambda s: (s["scale"], s["good"], s["skipped"])  # noqa: E731
        seq_j.append(t(jnet.loss_scale))
        seq_p.append(t(pnet.loss_scale))
    assert seq_p == seq_j
    assert seq_p[2][2] == 1 and seq_p[3][2] == 2
    assert pc.log == jc.log == [(3, "overflow:nan"), (4, "overflow:nan")]
