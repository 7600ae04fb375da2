"""The port's elastic averaging fleet against the JAX package's, on the
CPU (``deeplearning4j_tpu_torch/parallel/fleet.py``).

The net is JAX ``tests/test_fleet.py``'s MLP (4 -> 8 tanh -> 3 softmax,
SGD lr 0.1) in f64 from one init handed to both packages, on its seeded
data: 6 rounds of 12 examples. It draws nothing (no dropout), so the
packages' RNG streams never enter and the fleets agree at 1e-10:

* a static fleet of 3; a worker killed holding its split in round 2
  (reclaimed and re-executed by a survivor) and a replacement admitted
  before round 4; a fleet that grows from 2 to 4 at round 3; the loud
  uneven split (the same message);
* ``ElasticParameterAveragingTrainingMaster`` against JAX's;
* the file board reading heartbeat files JAX's board wrote, and the
  other way round, with expiry and announced departure;

and port against port: the kill-and-rejoin run bit-equal to the replay
of its membership schedule; a zombie whose heartbeat stalled fenced out
with no split counted twice (bit-equal to the replay); a partitioned
coordinator retrying; a poisoned split raising; the coordinator killed
at round 3 and resumed from its checkpoint bit-equal to the
uninterrupted run; OS-process workers over the TCP transport and the
spool directory equal to the in-process fleet at 1e-12, and a SIGTERM'd
worker announcing its departure so the next round re-forms.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import test_torch_mesh_spawn as ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-10
ROUNDS, GB = 6, 12
_RNG = np.random.default_rng(0)
X = _RNG.standard_normal((ROUNDS * GB, 4))
Y = np.eye(3)[_RNG.integers(0, 3, ROUNDS * GB)]


def round_batch(r):
    return X[r * GB:(r + 1) * GB], Y[r * GB:(r + 1) * GB]


def _init():
    from deeplearning4j_tpu_torch.nn import conf as pconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(ms.mlp_conf(pconf, "sgd"), device="cpu").init()
    return [{k: v.double().numpy() for k, v in p.items()}
            for p in net.params]


INIT = _init()


def port_net():
    from deeplearning4j_tpu_torch.nn import conf as pconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(ms.mlp_conf(pconf, "sgd"), device="cpu").init()
    net.params = [{k: torch.from_numpy(v.copy()) for k, v in p.items()}
                  for p in INIT]
    net.updater_state = net.updater.init(net.params)
    return net


def jax_net():
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(ms.mlp_conf(jconf, "sgd")).init()
    net.params = [{k: jnp.asarray(v) for k, v in p.items()} for p in INIT]
    net.updater_state = net.updater.init(net.params)
    return net


def port_fleet(**kw):
    from deeplearning4j_tpu_torch.parallel.fleet import (
        ElasticParameterAveragingTrainer,
    )

    kw.setdefault("heartbeat_s", 1.0)
    return ElasticParameterAveragingTrainer(
        port_net(), averaging_frequency=1, device="cpu", **kw)


def jax_fleet(**kw):
    from deeplearning4j_tpu.parallel.fleet import (
        ElasticParameterAveragingTrainer,
    )

    kw.setdefault("heartbeat_s", 1.0)
    return ElasticParameterAveragingTrainer(jax_net(), averaging_frequency=1,
                                            **kw)


def flat(params):
    return {f"{i}.{k}": np.asarray(v.numpy() if torch.is_tensor(v) else v,
                                   np.float64)
            for i, p in enumerate(params) for k, v in p.items()}


def assert_close(port_params, jax_params, tol=TOL):
    got, want = flat(port_params), flat(jax_params)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def bit_equal(a, b) -> bool:
    fa, fb = flat(a), flat(b)
    return fa.keys() == fb.keys() and all(
        np.array_equal(fa[k], fb[k]) for k in fa)


def run_rounds(fleet, rounds=ROUNDS, before=None):
    losses = []
    try:
        for r in range(rounds):
            if before is not None:
                before(fleet, r)
            losses.append(float(fleet.fit(*round_batch(r))))
    finally:
        fleet.close()
    return losses


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


# ---------------------------------------------------------------------------
# against the JAX package (f64)
# ---------------------------------------------------------------------------


class TestAgainstJax:
    def test_static_fleet(self, jax):
        pf, jf = port_fleet(num_workers=3), jax_fleet(num_workers=3)
        pl, jl = run_rounds(pf), run_rounds(jf)
        assert_close(pf.net.params, jf.net.params)
        np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-6)  # f32 means
        assert pf.resilience_stats["rounds"] == ROUNDS
        assert pf.resilience_stats["reclaims"] == 0

    def test_worker_loss_and_rejoin(self, jax):
        from deeplearning4j_tpu.resilience import FleetChaos as JChaos
        from deeplearning4j_tpu.resilience import FleetChaosConfig as JCfg

        from deeplearning4j_tpu_torch.resilience import (
            FleetChaos,
            FleetChaosConfig,
        )

        admit = lambda f, r: f.admit_worker("replacement") if r == 3 \
            else None
        plan = {"kill_split": {"round": 2, "split": 1}}
        pchaos, jchaos = FleetChaos(FleetChaosConfig(**plan)), \
            JChaos(JCfg(**plan))
        pf = port_fleet(num_workers=3, chaos=pchaos)
        jf = jax_fleet(num_workers=3, chaos=jchaos)
        run_rounds(pf, before=admit)
        run_rounds(jf, before=admit)
        assert pf.resilience_stats["reclaims"] == \
            jf.resilience_stats["reclaims"] == 1
        assert [e[0] for e in pchaos.log] == [e[0] for e in jchaos.log] \
            == [2]
        assert_close(pf.net.params, jf.net.params)
        assert pf.epoch == jf.epoch >= 3

    def test_join_reforms_rounds(self, jax):
        def grow(f, r):
            if r == 2:
                f.admit_worker()
                f.admit_worker()

        pf, jf = port_fleet(num_workers=2), jax_fleet(num_workers=2)
        run_rounds(pf, before=grow)
        run_rounds(jf, before=grow)
        assert_close(pf.net.params, jf.net.params)
        assert pf.epoch == jf.epoch >= 2
        assert sorted(pf._workers) == sorted(jf._workers)

    def test_uneven_split_raises_loud(self, jax):
        msgs = []
        for mk in (port_fleet, jax_fleet):
            fleet = mk(num_workers=3)
            try:
                with pytest.raises(ValueError,
                                   match="not divisible by 3 live") as e:
                    fleet.fit(X[:10], Y[:10])
                msgs.append(str(e.value))
            finally:
                fleet.close()
        assert msgs[0] == msgs[1]

    def test_elastic_training_master(self, jax):
        from deeplearning4j_tpu.datasets.iterator import (
            ListDataSetIterator as JIt,
        )
        from deeplearning4j_tpu.parallel.training_master import (
            ElasticParameterAveragingTrainingMaster as JMaster,
        )

        from deeplearning4j_tpu_torch.datasets.iterator import (
            ListDataSetIterator,
        )
        from deeplearning4j_tpu_torch.parallel.training_master import (
            ElasticParameterAveragingTrainingMaster,
        )

        pn, jn = port_net(), jax_net()
        kw = dict(num_workers=2, batch_size_per_worker=6,
                  averaging_frequency=1, fleet_kwargs={"heartbeat_s": 1.0})
        with ElasticParameterAveragingTrainingMaster(device="cpu",
                                                     **kw) as master:
            master.execute_training(pn, ListDataSetIterator(X[:48], Y[:48],
                                                            batch=12))
        with JMaster(**kw) as jmaster:
            jmaster.execute_training(jn, JIt(X[:48], Y[:48], batch=12))
        assert master.fleet is None
        assert_close(pn.params, jn.params)

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_file_board_read_across_packages(self, jax, tmp_path, writer):
        """Heartbeat files one package's board writes are the other's
        live members; an announced departure and a stale heartbeat read
        the same on both sides."""
        from deeplearning4j_tpu.parallel.fleet import (
            FileMembershipBoard as JBoard,
        )

        from deeplearning4j_tpu_torch.parallel.fleet import (
            FileMembershipBoard,
        )

        w, r = ((JBoard, FileMembershipBoard) if writer == "jax"
                else (FileMembershipBoard, JBoard))
        wb = w(str(tmp_path), heartbeat_timeout=0.2)
        rb = r(str(tmp_path), heartbeat_timeout=0.2)
        wb.register_worker("a")
        wb.register_worker("b")
        assert rb.live_workers() == ["a", "b"]
        assert sorted(os.listdir(tmp_path)) == ["member-a.hb",
                                                "member-b.hb"]
        wb.deregister_worker("a")
        assert rb.live_workers() == ["b"]
        time.sleep(0.3)
        assert rb.live_workers() == []
        wb.heartbeat("b")
        assert rb.live_workers() == ["b"]

    def test_shard_for_equal(self, jax):
        from deeplearning4j_tpu.parallel.fleet import shard_for as jshard

        from deeplearning4j_tpu_torch.parallel.fleet import shard_for

        for wid, live in (("b", ["c", "a", "b"]), ("gone", ["a"]),
                          ("a", ["a"])):
            assert shard_for(wid, live) == jshard(wid, live)


# ---------------------------------------------------------------------------
# port against port
# ---------------------------------------------------------------------------


class TestFaults:
    def test_loss_and_rejoin_bit_equal_to_replay(self):
        from deeplearning4j_tpu_torch.resilience import (
            FleetChaos,
            FleetChaosConfig,
        )

        f1 = port_fleet(num_workers=3, chaos=FleetChaos(FleetChaosConfig(
            kill_split={"round": 2, "split": 1})))
        l1 = run_rounds(f1, before=lambda f, r: f.admit_worker(
            "replacement") if r == 3 else None)

        def replay(f, r):
            if r == 2:
                f.evict_worker("w1")
            if r == 3:
                f.admit_worker("replacement")

        f2 = port_fleet(num_workers=3)
        l2 = run_rounds(f2, before=replay)
        assert l1 == l2
        assert bit_equal(f1.net.params, f2.net.params)
        assert bit_equal(f1.net.updater_state, f2.net.updater_state)

    def test_stalled_heartbeat_fenced_no_double_count(self):
        from deeplearning4j_tpu_torch.resilience import (
            FleetChaos,
            FleetChaosConfig,
        )

        f1 = port_fleet(num_workers=2, heartbeat_s=0.4,
                        chaos=FleetChaos(FleetChaosConfig(stall_heartbeat={
                            "round": 1, "split": 0, "sleep_s": 2.5})))
        try:
            for r in range(2):
                f1.fit(*round_batch(r))
            deadline = time.monotonic() + 10.0
            while (f1.tracker.stale_completions < 1
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            f1.close()
        assert f1.resilience_stats["reclaims"] >= 1
        assert f1.tracker.stale_completions >= 1
        f2 = port_fleet(num_workers=2, heartbeat_s=0.4)
        try:
            f2.fit(*round_batch(0))
            f2.evict_worker("w1")
            f2.fit(*round_batch(1))
        finally:
            f2.close()
        assert bit_equal(f1.net.params, f2.net.params)

    def test_partitioned_coordinator_retries(self):
        from deeplearning4j_tpu_torch.resilience import (
            FleetChaos,
            FleetChaosConfig,
        )

        f1 = port_fleet(num_workers=2, chaos=FleetChaos(FleetChaosConfig(
            partition_coordinator={"at_round": 2, "polls": 3})))
        run_rounds(f1, rounds=3)
        assert f1.resilience_stats["membership_retries"] == 3
        f2 = port_fleet(num_workers=2)
        run_rounds(f2, rounds=3)
        assert bit_equal(f1.net.params, f2.net.params)

    def test_poisoned_split_is_loud(self, monkeypatch):
        fleet = port_fleet(num_workers=2, job_max_attempts=2,
                           round_timeout_s=30.0)
        monkeypatch.setattr(
            fleet, "_execute_split",
            lambda payload: (_ for _ in ()).throw(RuntimeError("boom")))
        try:
            with pytest.raises(RuntimeError, match="poisoned"):
                fleet.fit(*round_batch(0))
        finally:
            fleet.close()

    def test_kill_and_resume_bit_exact(self, tmp_path):
        from deeplearning4j_tpu_torch.datasets.iterator import (
            ListDataSetIterator,
        )
        from deeplearning4j_tpu_torch.resilience import (
            ChaosConfig,
            ChaosMonkey,
            CheckpointManager,
            InjectedKill,
            ResilientTrainer,
        )

        mk_it = lambda: ListDataSetIterator(X, Y, batch=GB)
        base_fleet = port_fleet(num_workers=2)
        baseline = ResilientTrainer(base_fleet, device="cpu")
        baseline.fit(mk_it(), num_epochs=1)
        base_fleet.close()
        mgr = CheckpointManager(str(tmp_path), every_steps=2, keep_last=2)
        killed_fleet = port_fleet(num_workers=2)
        killed = ResilientTrainer(
            killed_fleet, mgr, chaos=ChaosMonkey(ChaosConfig(kill_at_step=3)),
            device="cpu")
        with pytest.raises(InjectedKill):
            killed.fit(mk_it(), num_epochs=1)
        mgr.close()
        killed_fleet.close()
        mgr2 = CheckpointManager(str(tmp_path), every_steps=2, keep_last=2)
        resumed_fleet = port_fleet(num_workers=2)
        resumed = ResilientTrainer(resumed_fleet, mgr2, device="cpu")
        resumed.fit(mk_it(), num_epochs=1)
        mgr2.close()
        resumed_fleet.close()
        assert resumed.resumed_step == 2
        assert killed.losses[:2] + resumed.losses == baseline.losses
        assert bit_equal(baseline.net.params, resumed.net.params)
        assert resumed.net.resilience_stats["rounds"] == 4


WORKER = (
    "import sys, torch; torch.set_num_threads(1); "
    "from deeplearning4j_tpu_torch.parallel.fleet import run_worker; "
    "run_worker(sys.argv[1], sys.argv[2], sys.argv[3], device='cpu', "
    "stop_after_idle_s=60.0)")


def _spawn(addr, wid, spool):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", WORKER, addr, wid, spool],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _await(fleet, wid, proc, present=True, timeout=60.0):
    deadline = time.monotonic() + timeout
    while (wid in fleet.tracker.live_workers()) != present:
        if present and proc.poll() is not None:
            raise AssertionError(f"worker died: {proc.stderr.read()[-800:]}")
        assert time.monotonic() < deadline, "membership never changed"
        time.sleep(0.05)


class TestProcesses:
    def test_os_process_workers_over_tcp(self, tmp_path):
        """Two OS-process workers (run_worker: the tracker's TCP wire for
        control, npz files in the spool for data) train 3 rounds equal to
        the in-process fleet; then one takes a SIGTERM, fails nothing
        back, announces its departure, and round 4 re-forms over one."""
        spool = str(tmp_path / "spool")
        fleet = port_fleet(num_workers=0, heartbeat_s=5.0, spool_dir=spool)
        addr = fleet.serve()
        procs = [_spawn(addr, f"ext{i}", spool) for i in range(2)]
        try:
            for i, p in enumerate(procs):
                _await(fleet, f"ext{i}", p)
            for r in range(3):
                fleet.fit(*round_batch(r))
            procs[1].send_signal(signal.SIGTERM)
            procs[1].wait(timeout=30)
            assert procs[1].returncode == 143
            assert "FLEET_WORKER_PREEMPTED ext1" in procs[1].stdout.read()
            _await(fleet, "ext1", procs[1], present=False)
            fleet.fit(*round_batch(3))
            assert fleet.tracker.live_workers() == ["ext0"]
        finally:
            fleet.close()
            for p in procs:
                if p.poll() is None:
                    p.terminate()
                    p.wait(timeout=30)

        def replay(f, r):
            if r == 3:
                f.evict_worker("w1")

        ref = port_fleet(num_workers=2)
        run_rounds(ref, rounds=4, before=replay)
        got, want = flat(fleet.net.params), flat(ref.net.params)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                       err_msg=k)
        assert any(n.startswith("state-") for n in os.listdir(spool))
