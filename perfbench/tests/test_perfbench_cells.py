"""Whole runs of the training cells at a tiny size on the CPU: the
harness's look for a card is skipped, everything else runs (set-up, the
window, the reference, the comparison). A sound program reads correct;
the same run with the timed path broken underneath, or with the control
(the reference in the precision below the configuration's) in the
program's place, reads not correct."""

from __future__ import annotations

import pytest

from conftest import cpu_context, tiny_cell
from perfbench import harness

CELLS = ["gpt2-medium.train", "bert-base.mlm"]


def _run(cell, **kw):
    ctx = cpu_context(cell, **kw)
    oc, device = harness.run_cell(cell, ctx)
    return harness.result_line(cell, ctx, oc, device)


def _patch_step(monkeypatch, cell, wrap):
    """Build the cell's program with its step wrapped by ``wrap``."""
    from deeplearning4j_tpu_torch.models import bert, transformer

    mod = transformer if cell.traffic["driver"] == "lm_train" else bert
    orig = mod.make_train_step
    monkeypatch.setattr(mod, "make_train_step",
                        lambda *a, **k: _keep_flag(wrap(orig(*a, **k)),
                                                   orig(*a, **k)))


def _keep_flag(new, old):
    new.loss_scaled = old.loss_scaled
    return new


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(spec, name):
    line = _run(tiny_cell(spec, name))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["metrics"]["train_tokens_per_s"]["value"] > 0
    assert line["metrics"]["setup_s"]["value"] > 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_returns_its_state_unchanged_is_caught(spec, monkeypatch,
                                                           name):
    cell = tiny_cell(spec, name)

    def frozen(step):
        def run(params, opt, *batch):
            return params, opt, step(params, opt, *batch)[2]
        return run

    _patch_step(monkeypatch, cell, frozen)
    line = _run(cell)
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_is_caught(spec, monkeypatch, name):
    cell = tiny_cell(spec, name)

    def half(step):
        def run(params, opt, *batch):
            n = batch[0].shape[0] // 2
            return step(params, opt, *(b[:n] for b in batch))
        return run

    _patch_step(monkeypatch, cell, half)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_the_programs_place_is_caught(spec, monkeypatch,
                                                     name):
    cell = tiny_cell(spec, name)
    driver = harness.load_module(cell.files / "drivers"
                                 / f"{cell.traffic['driver']}.py")
    setup = driver.setup

    def control_setup(cfg, traffic, seed, device):
        fit, data, _ = setup(cfg, traffic, seed, device)
        ctl = driver.reference(cfg, traffic, seed, device, data,
                               precision=cfg["precision"]["control"])
        return fit, data, ctl

    monkeypatch.setattr(driver, "setup", control_setup)
    monkeypatch.setattr(harness, "load_module", lambda *a, **k: driver)
    assert not _run(cell)["correct"]
