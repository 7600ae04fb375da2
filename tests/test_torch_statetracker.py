"""The port's StateTracker against the JAX package's, on the CPU
(``deeplearning4j_tpu_torch/parallel/statetracker.py``).

* JAX ``tests/test_statetracker.py`` run on the port: its source with
  every ``deeplearning4j_tpu.`` import pointed at the port's package is
  executed into this module, so each of its test classes (the job
  lifecycle, requeue, heartbeat expiry and reclaim, the dead-letter cap,
  fenced completions, membership epochs, both work routers, the file
  registry, and the cross-process protocol against real worker
  subprocesses over TCP) runs here on the port, unchanged.
* The JSON wire both ways: the port's ``RemoteStateTracker`` drives the
  JAX ``StateTrackerServer``, and the JAX client drives the port's
  server, through the same script (lifecycle, fencing, reclaim after a
  silent death, the dead-letter cap, membership epochs, params and the
  error reply); every answer equals the one the same script gets from
  its own package's pair.
"""

import os
import re
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ported_source() -> str:
    with open(os.path.join(REPO, "tests", "test_statetracker.py"),
              encoding="utf-8") as f:
        src = f.read()
    src = src.replace("deeplearning4j_tpu.", "deeplearning4j_tpu_torch.")
    # its worker subprocesses import the package from this checkout
    return re.sub(r'env\["PYTHONPATH"\] = "[^"]*:"',
                  'env["PYTHONPATH"] = REPO + ":"', src)


exec(compile(_ported_source(), os.path.join(REPO, "tests",
                                            "test_statetracker.py"), "exec"))


# ---------------------------------------------------------------------------
# the JSON wire across the packages
# ---------------------------------------------------------------------------


def _script(client_mod, address):
    """One session over the wire; returns every answer, in order."""
    t = client_mod.RemoteStateTracker.from_address(address)
    out = []
    try:
        out.append(t.register_worker("a"))
        out.append(t.register_worker("b"))
        out.append(t.membership())
        t.add_job(client_mod.Job("j1", {"n": 1}))
        t.add_job(client_mod.Job("j2", {"n": 2}))
        j1 = t.request_job("a")
        out.append((j1.job_id, j1.payload, j1.attempts))
        out.append(t.complete_job("j1", {"v": 2}, attempt=j1.attempts + 1))
        out.append(t.complete_job("j1", {"v": 2}, attempt=j1.attempts))
        out.append(t.stale_completion_count())
        j2 = t.request_job("b")  # b takes j2 and goes silent
        out.append((j2.job_id, j2.attempts))
        t.heartbeat("a")
        time.sleep(0.25)
        t.heartbeat("a")
        out.append(sorted(t.dead_workers()))
        out.append(t.reclaim_dead_jobs())
        out.append(t.live_workers())
        out.append(t.membership()["epoch"])
        again = t.request_job("a")
        out.append((again.job_id, again.attempts))
        out.append(t.fail_job("j2", attempt=again.attempts))  # the cap: 2
        out.append(t.poisoned_jobs())
        out.append(t.counts())
        t.set_params("merged", [1.5, 2.5])
        out.append(t.get_params("merged"))
        out.append(t.results())
        out.append(t.drain_results())
        out.append(t.results())
        out.append(t.deregister_worker("a"))
        try:
            t._call("no_such_method")
        except RuntimeError as e:
            out.append(str(e))
    finally:
        t.close()
    return out


def _serve(server_mod):
    tracker = server_mod.StateTracker(heartbeat_timeout=0.15, max_attempts=2)
    return server_mod.StateTrackerServer(tracker).start()


@pytest.fixture(scope="module")
def packages():
    pytest.importorskip("jax")
    from deeplearning4j_tpu.parallel import statetracker as jst

    from deeplearning4j_tpu_torch.parallel import statetracker as pst

    return jst, pst


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_wire_answers_equal_across_packages(packages, client, server):
    """A client of one package against the server of the other gives the
    answers the same script gets within the server's own package."""
    jst, pst = packages
    mods = {"jax": jst, "port": pst}
    srv = _serve(mods[server])
    try:
        got = _script(mods[client], srv.address)
    finally:
        srv.stop()
    own = _serve(mods[server])
    try:
        want = _script(mods[server], own.address)
    finally:
        own.stop()
    assert got == want
    # the script reached the paths it names
    assert got[4] is False and got[5] is True and got[6] == 1
    assert got[8] == ["b"] and got[9] == 1 and got[10] == ["a"]
    assert got[13] is False and got[14] == {"j2": 2}
    assert got[-1].startswith("remote state tracker: ValueError")
