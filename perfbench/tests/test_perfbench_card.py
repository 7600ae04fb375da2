"""The comparison at each cell's own size on the card: the program reads
within every limit and the control (the reference in the precision below
the configuration's, in the program's place) fails one. Run on the card:

    python -m pytest -m gpu -p no:cacheprovider -q perfbench/tests/test_perfbench_card.py
"""

from __future__ import annotations

import pytest

from perfbench import checks, harness, training

SEED = 2**31 + 4242


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gpt2-medium.train", "bert-base.mlm"])
def test_training_control_fails_at_the_cells_size(spec, card, name):
    cell = harness.resolve_cell(spec, name)
    driver = harness.load_module(cell.files / "drivers"
                                 / f"{cell.traffic['driver']}.py")
    cfg, traffic, limits = cell.config, cell.traffic, cell.limits["limits"]
    fit, data, prog = driver.setup(cfg, traffic, SEED, card)
    del fit
    training.free_device(card)
    ref = driver.reference(cfg, traffic, SEED, card, data)
    ctl = driver.reference(cfg, traffic, SEED, card, data,
                           precision=cfg["precision"]["control"])
    assert harness.is_correct(checks.training_checks(prog, ref, limits))
    assert not harness.is_correct(checks.training_checks(ctl, ref, limits))
