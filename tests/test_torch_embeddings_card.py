"""Card tests of the NLP, graph and t-SNE models' device steps: each step
(``dbow_step``, ``dm_step``, ``infer_dbow_step``, ``glove_step``,
DeepWalk's ``hs_body``, ``tsne_step``) run once on the card and once on
the CPU from the same seeded f32 inputs (``chip_smoke.emb_step_inputs``,
at the smoke's widths), within 1e-5 of each output's largest entry
(``index_add_`` on the card sums duplicate rows in another order); and a
ParagraphVectors fit on the card whose word co-training launches K3 once
per batch and its plain version never.

Every test carries the ``gpu`` marker and skips where there is no card.
This file imports no JAX; on the machine with the card it runs from the
repository root as

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_embeddings_card.py
"""

import numpy as np
import pytest
import torch

TOL = 1e-5  # of each output's largest entry


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def affinities(seed: int, n: int = 1024) -> np.ndarray:
    """A symmetric t-SNE P [n, n] with a zero diagonal, clamped at 1e-12."""
    rng = np.random.default_rng(seed)
    p = rng.random((n, n)) ** 8
    p = p + p.T
    np.fill_diagonal(p, 0.0)
    return np.maximum(p / p.sum(), 1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dbow_step", "dm_step", "infer_dbow_step",
                                  "glove_step", "hs_body", "tsne_step"])
def test_step_on_card_matches_cpu(name):
    dev = _card()
    import chip_smoke

    inp = chip_smoke.emb_step_inputs(0, affinities(0), v=8192)
    errs = chip_smoke.emb_step_errors(name, inp, dev)
    assert max(errs.values()) <= TOL, errs


@pytest.mark.gpu
def test_paragraph_vectors_cotraining_runs_k3_once_a_batch():
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        ParagraphVectors,
    )
    from deeplearning4j_tpu_torch.ops.sgns import sgns_step, sgns_step_plain

    dev = _card()
    rng = np.random.default_rng(1)
    sents = [" ".join(f"w{int(x)}" for x in rng.zipf(1.5, 40) if x < 300)
             for _ in range(200)]
    labels = [f"L{i % 5}" for i in range(200)]
    for fn in (sgns_step, sgns_step_plain):
        fn.launches = 0
    pv = ParagraphVectors(layer_size=32, negative=5, batch_size=256,
                          device=dev).fit_labelled(sents, labels)
    st = pv.fit_stats
    assert sgns_step.launches == st["words"]["batches"] > 0
    assert sgns_step_plain.launches == 0
    assert np.isfinite(pv.doc_vectors).all()
    assert pv.nearest_labels(sents[0], 5)[0] in set(labels)
