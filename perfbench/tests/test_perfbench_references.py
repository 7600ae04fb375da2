"""Each plain reference against the port's plain path at a tiny size on
the CPU (the port's kernels' plain versions run there): the same weights
and rows give the same logits, losses, masks and Adam steps."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import TINY_MODEL
from perfbench import weights
from perfbench.reference import adam, bert, gpt2
from perfbench.reference.lowprec import matmul, round_fp8, round_tf32

F64 = torch.float64


def _tiny(init, **extra):
    return dict(TINY_MODEL, init=init, ln_eps=1e-5, learning_rate=1e-3,
                **extra)


def _f64(tree):
    return {k: _f64(v) if isinstance(v, dict) else v.to(F64)
            for k, v in tree.items()}


def test_gpt2_reference_matches_the_port_forward():
    from deeplearning4j_tpu_torch.models import transformer as tm

    m = _tiny("transformer")
    # f32: the port's strict policy computes the blocks in f32 whatever
    # the params' dtype
    params = weights.make(m, 3, torch.device("cpu"))
    cfg = tm.TransformerConfig(
        vocab_size=m["vocab_size"], d_model=m["d_model"],
        n_layers=m["n_layers"], n_heads=m["n_heads"], d_ff=m["d_ff"],
        max_len=m["max_len"], use_flash=False)
    tokens = torch.randint(0, m["vocab_size"], (3, 20),
                           generator=torch.Generator().manual_seed(0))
    want, _ = tm.forward(params, tokens, cfg)
    got = gpt2.logits(params, tokens, m)
    assert torch.allclose(got, want, rtol=0, atol=1e-5)


def test_bert_reference_matches_the_port_forward_and_masks():
    from deeplearning4j_tpu_torch.models import bert as bm

    m = _tiny("bert", pad_token_id=0, mask_token_id=103, mlm_prob=0.15)
    params = _f64(weights.make(m, 4, torch.device("cpu")))
    cfg = bm.BertConfig(vocab_size=m["vocab_size"], d_model=m["d_model"],
                        n_layers=m["n_layers"], n_heads=m["n_heads"],
                        d_ff=m["d_ff"], max_len=m["max_len"],
                        pad_token_id=0, mask_token_id=103)
    rows = np.random.default_rng(0).integers(1, m["vocab_size"], (3, 24))
    rows[0, 10:] = 0
    rows[2, 17:] = 0
    tokens = torch.as_tensor(rows)
    want = bm.mlm_logits(params, tokens, cfg)
    got = bert.logits(params, tokens, m)
    keep = tokens != 0  # pad queries feed nothing the loss reads
    assert torch.allclose(got[keep], want[keep], rtol=0, atol=1e-10)
    for seed in (0, 2**31 + 9):
        a = bm.mask_tokens(rows, cfg, np.random.default_rng(seed))
        b = bert.draw_masks(rows, m, np.random.default_rng(seed))
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


def test_reference_adam_matches_the_port_update():
    from deeplearning4j_tpu_torch.models import transformer as tm

    g = torch.Generator().manual_seed(1)
    p = {"a": torch.randn(5, 3, generator=g, dtype=F64),
         "b": torch.randn(4, generator=g, dtype=F64)}
    opt = tm.init_opt_state(p, loss_scaled=False)
    state = adam.init(p)
    ref = dict(p)
    for t in range(1, 4):
        grads = {k: torch.randn(v.shape, generator=g, dtype=F64)
                 for k, v in p.items()}
        p, opt = tm._adam_update(p, grads, opt,
                                 torch.tensor(1e-2, dtype=F64))
        ref = adam.step(ref, grads, state, t, 1e-2)
    # the port takes 1 - b2^t in f32: ~3e-5 of each update of 1e-2
    for k in p:
        assert torch.allclose(p[k], ref[k], rtol=0, atol=1e-6)


def test_lower_precision_products():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, 3.0])
    assert torch.equal(round_tf32(x), torch.tensor([1.0, 1.0,
                                                    1.0 + 2**-10, 3.0]))
    y = torch.randn(1000, generator=torch.Generator().manual_seed(2))
    e4 = (round_fp8(y, torch.float8_e4m3fn) - y).abs().max()
    tf = (round_tf32(y) - y).abs().max()
    assert float(e4) > 10 * float(tf) > 0
    a = torch.randn(6, 5, requires_grad=True)
    b = torch.randn(5, 4, requires_grad=True)
    for prec in ("f32", "tf32", "fp8"):
        out = matmul(prec)(a, b)
        assert out.shape == (6, 4)
        out.sum().backward()
        assert a.grad is not None and b.grad is not None
        a.grad = b.grad = None
    with pytest.raises(ValueError):
        matmul("int3")
