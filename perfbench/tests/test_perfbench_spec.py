"""BENCHMARK.json against the benchmark's contract, the result line's
schema, and a cell added by files alone."""

from __future__ import annotations

import json
import re
import textwrap

import pytest

from conftest import ROOT
from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden_size|intermediate_size|latent|state_size|"
                   r"projection|_dim$|_rank$|head_size|n_embd|n_inner|"
                   r"expansion|experts_per_tok)")


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "perfbench/run.py"]
    assert spec["paths"] == ["perfbench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024


def test_names_units_and_entries(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
        file = harness.load_json(ROOT / c["file"])
        assert file["source"] == c["source"]
        assert sorted(file["reduced"]) == sorted(c["reduced"])
    seen = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_resolves_and_reports_enough(spec):
    for w in spec["workloads"]:
        cell = harness.resolve_cell(spec, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
        assert (ROOT / "perfbench" / "drivers"
                / f"{cell.traffic['driver']}.py").is_file()
        assert cell.limits["limits"]


def test_run_seconds_fit_the_check_with_24_cells(spec):
    rs = spec["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_result_line_schema(spec):
    cell = harness.resolve_cell(spec, spec["workloads"][0]["name"])
    ctx = harness.Context(cell=cell, seed=1, seconds=1.0, trace=False,
                          device=None, t_start=0.0, setup_s=12.5)
    oc = harness.Outcome(e2e={"train_tokens_per_s": 1000.0}, attempted=4,
                         failed=0, checks=[("loss_gap", 1e-4, 1e-2)],
                         counters={}, memory_peak_bytes=123)
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1, "memory_peak_bytes": 123}
    line = harness.result_line(cell, ctx, oc, device)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"]["setup_s"] == {"value": 12.5, "unit": "s"}
    assert line["metrics"]["train_tokens_per_s"]["unit"] == "tokens/s"
    assert line["checks"] == {"loss_gap": {"value": 1e-4, "limit": 1e-2}}
    bad = harness.Outcome(e2e={}, attempted=4, failed=0,
                          checks=[("loss_gap", float("nan"), 1e-2)],
                          counters={}, memory_peak_bytes=0)
    assert harness.result_line(cell, ctx, bad, device)["correct"] is False
    none = harness.Outcome(e2e={}, attempted=0, failed=0, checks=[],
                           counters={}, memory_peak_bytes=0)
    assert harness.result_line(cell, ctx, none, device)["correct"] is False


def test_a_cell_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix, driver and per-layer metric, as
    new files and new BENCHMARK.json entries, run through the harness
    without an edit to any file it had."""
    pb = tmp_path / "perfbench"
    for d in ("configs", "traffic", "drivers", "metrics", "limits"):
        (pb / d).mkdir(parents=True)
    (pb / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "source": "https://example.org/toy", "reduced": [],
         "model": {"width": 8}}))
    (pb / "traffic" / "ones.json").write_text(json.dumps(
        {"driver": "ones", "count": 5}))
    (pb / "limits" / "toy.ones.json").write_text(json.dumps(
        {"limits": {"err": 0.5}}))
    (pb / "drivers" / "ones.py").write_text(textwrap.dedent("""
        from perfbench.harness import Outcome

        def run(ctx):
            ctx.window_opened()
            n = ctx.cell.traffic["count"] * ctx.cell.config["model"]["width"]
            return Outcome(e2e={"items_per_s": float(n)}, attempted=n,
                           failed=0, checks=[("err", 0.0, ctx.limit("err"))],
                           counters={"n": n}, memory_peak_bytes=1)
        """))
    (pb / "metrics" / "n_items.py").write_text(
        "def read(run):\n    return run.counters['n'] / 2\n")
    spec = {"configs": [{"name": "toy", "source": "https://example.org/toy",
                         "file": "perfbench/configs/toy.json", "reduced": [],
                         "why": "a toy"}],
            "workloads": [{"name": "toy.ones", "config": "toy",
                           "traffic": "ones", "chips": 1, "why": "a toy"}],
            "end_to_end": [{"name": "items_per_s", "unit": "items/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock"},
                           {"name": "setup_s", "unit": "s", "better": "lower",
                            "bound": 0.25, "source": "host_clock"}],
            "per_layer": [{"name": "n_items", "unit": "items",
                           "better": "higher", "source": "program_counter",
                           "layer": "toy", "moves": "items_per_s"}]}
    cell = harness.resolve_cell(spec, "toy.ones", root=tmp_path)
    import torch

    ctx = harness.Context(cell=cell, seed=3, seconds=1.0, trace=True,
                          device=torch.device("cpu"), t_start=0.0)
    oc, device = harness.run_cell(cell, ctx)
    line = harness.result_line(cell, ctx, oc, device)
    assert line["correct"] and line["metrics"]["items_per_s"]["value"] == 40
    run = harness.Run(cell=cell, counters=oc.counters, trace=None,
                      device_kind="cpu", peaks={})
    assert harness.read_per_layer(cell, run) == {
        "n_items": {"value": 20.0, "unit": "items"}}


def test_forbidden_names_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "deeplearning4j_tpu_torch_x",
                        types.ModuleType("deeplearning4j_tpu_torch_x"))
    assert "deeplearning4j_tpu_torch_x" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.fake",
                        types.ModuleType("jaxlib.fake"))
    assert "jaxlib.fake" in harness.forbidden_loaded()


def test_a_metric_reader_that_loads_jax_leaves_no_result(tmp_path, capsys):
    """The look for forbidden modules comes after the per-layer readers:
    one that loads ``jax`` at run time leaves exit code 4 and no line."""
    import sys

    import torch

    pb = tmp_path / "perfbench"
    for d in ("configs", "traffic", "drivers", "metrics", "limits"):
        (pb / d).mkdir(parents=True)
    (pb / "configs" / "toy.json").write_text(json.dumps({"model": {}}))
    (pb / "traffic" / "ones.json").write_text(json.dumps({"driver": "ones"}))
    (pb / "limits" / "toy.ones.json").write_text(json.dumps({"limits": {}}))
    (pb / "drivers" / "ones.py").write_text(textwrap.dedent("""
        from perfbench.harness import Outcome

        def run(ctx):
            ctx.window_opened()
            return Outcome(e2e={"items_per_s": 1.0}, attempted=1, failed=0,
                           checks=[("err", 0.0, 1.0)], counters={},
                           memory_peak_bytes=1)
        """))
    (pb / "metrics" / "loads_jax.py").write_text(textwrap.dedent("""
        import sys
        import types

        def read(run):
            sys.modules["jax"] = types.ModuleType("jax")
            return 1.0
        """))
    spec = {"configs": [{"name": "toy", "file": "perfbench/configs/toy.json"}],
            "workloads": [{"name": "toy.ones", "config": "toy",
                           "traffic": "ones", "chips": 1}],
            "end_to_end": [{"name": "items_per_s", "unit": "items/s"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "loads_jax", "unit": "%",
                           "moves": "items_per_s"}]}
    cell = harness.resolve_cell(spec, "toy.ones", root=tmp_path)
    before = sys.modules.get("jax")
    try:
        ctx = harness.Context(cell=cell, seed=3, seconds=1.0, trace=True,
                              device=torch.device("cpu"), t_start=0.0)
        assert harness.report(cell, ctx) == 4
    finally:
        if before is None:
            sys.modules.pop("jax", None)
        else:
            sys.modules["jax"] = before
    out, err = capsys.readouterr()
    assert out == ""
    assert "jax" in err and "no result" in err
    # the same cell with a reader that loads nothing prints its line
    (pb / "metrics" / "loads_jax.py").write_text(
        "def read(run):\n    return 1.0\n")
    ctx = harness.Context(cell=cell, seed=3, seconds=1.0, trace=True,
                          device=torch.device("cpu"), t_start=0.0)
    assert harness.report(cell, ctx) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metrics"] == {"loads_jax": {"value": 1.0, "unit": "%"}}


@pytest.mark.parametrize("workload", ["gpt2-medium.train", "bert-base.mlm"])
def test_entry_point_refuses_without_a_card(workload, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert harness.main(["--workload", workload, "--seed", "1",
                         "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
