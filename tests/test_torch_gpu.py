"""Card tests of the PyTorch port: each CUDA kernel against its plain
version, the kernel build, and the serving path on the card.

Every test here carries the ``gpu`` marker and decides inside its body
whether there is a card, skipping where there is none. This file imports
no JAX, so on the machine with the card it runs as

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_*.py

(``--noconftest``: ``tests/conftest.py`` configures JAX, which that
machine does not have; the files that compare against JAX skip there).
Tolerances: f32 inputs 1e-4 abs, bf16 inputs 2e-2 abs on flash O (f32
math, O rounded to bf16), 1e-3 abs on lse and on paged attention's f32
output.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_attention as port_flash
from deeplearning4j_tpu_torch.ops import paged_attention as port_paged


def _qkv(seed, n, t, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _port(a, device="cpu", dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def _arena_case(seed, s, h, hd, bt, m):
    """Lane i owns distinct arena blocks (from 1; 0 is trash): lane 0 at
    pos 1, lane 1 at pos 0, lane 2 at the full window, the rest mid-block
    across blocks."""
    rng = np.random.default_rng(seed)
    n_blocks = s * m
    q = rng.standard_normal((s, h, hd)).astype(np.float32)
    ck = rng.standard_normal((n_blocks + 1, bt, h, hd)).astype(np.float32)
    cv = rng.standard_normal((n_blocks + 1, bt, h, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_blocks + 1))
    pos = np.array([1, 0, m * bt - 1] + [
        (1 + i % m) * bt - 1 - (i % bt) for i in range(3, s)], np.int32)
    tables = np.zeros((s, m), np.int32)
    nxt = 0
    for i in range(s):
        used = int(pos[i]) // bt + 1
        tables[i, :used] = perm[nxt:nxt + used]
        nxt += used
    return q, ck, cv, tables, pos


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "-m gpu --noconftest tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,d", [(8, 16), (96, 32), (192, 64), (130, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_on_card(t, d, causal, dtype, tol):
    dev = _need_card()
    q, k, v = (_port(a, dev, dtype) for a in _qkv(t, 2, t, 3, d))
    before = port_flash.flash_attention.launches
    o, lse = port_flash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert port_flash.flash_attention.launches == before + 1
    ref_o, ref_lse = port_flash.flash_attention_plain(q, k, v,
                                                      causal=causal)
    assert (o.float() - ref_o.float()).abs().max().item() < tol
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_paged_kernel_matches_plain_on_card(hd, dtype):
    dev = _need_card()
    q, ck, cv, tables, pos = _arena_case(hd, s=9, h=3, hd=hd, bt=16, m=5)
    qt, ckt, cvt = (_port(a, dev, dtype) for a in (q, ck, cv))
    tt = torch.from_numpy(tables).to(dev)
    pt = torch.from_numpy(pos).to(dev)
    before = port_paged.paged_attention.launches
    out = port_paged.paged_attention(qt, ckt, cvt, tt, pt)
    torch.cuda.synchronize()
    assert port_paged.paged_attention.launches == before + 1
    ref = port_paged.paged_attention_plain(qt, ckt, cvt, tt, pt)
    assert (out - ref).abs().max().item() < 1e-3
    ckt[0], cvt[0] = 1e6, -1e6
    poisoned = port_paged.paged_attention(qt, ckt, cvt, tt, pt)
    assert torch.equal(out, poisoned)


@pytest.mark.gpu
def test_card_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _need_card()
    q = torch.zeros((1, 8, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head size"):
        port_flash.flash_attention(q, q, q, causal=True)
    with pytest.raises(ValueError, match="int32"):
        port_paged.paged_attention(
            torch.zeros((1, 2, 16), device=dev),
            torch.zeros((3, 4, 2, 16), device=dev),
            torch.zeros((3, 4, 2, 16), device=dev),
            torch.zeros((1, 2), dtype=torch.int64, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))


@pytest.mark.gpu
def test_kernels_build_with_nvcc():
    _need_card()
    from deeplearning4j_tpu_torch.ops import build

    for res in build.build(["flash_attention", "paged_attention"]):
        assert res.path.exists()
        assert "registers" in res.log


@pytest.mark.gpu
def test_serving_on_the_card_goes_through_both_kernels():
    """A small f32 model served on the card: answers arrive, stream ==
    non-stream, and every attention call of the path was a kernel
    launch — the plain versions never ran."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine

    lm = TransformerLM(TransformerConfig(vocab_size=64, d_model=64,
                                         n_layers=2, n_heads=4, d_ff=128,
                                         max_len=128), device=dev)
    eng = ServingEngine(lm, kv_blocks=32, device=dev)
    try:
        for fn in (port_flash.flash_attention,
                   port_flash.flash_attention_plain,
                   port_paged.paged_attention,
                   port_paged.paged_attention_plain):
            fn.launches = 0
        out = eng.generate([[1, 2, 3, 4, 5] * 7], 12, temperature=0.8,
                           seed=3)[0]
        streamed = list(eng.generate_stream([1, 2, 3, 4, 5] * 7, 12,
                                            temperature=0.8, seed=3))
        assert streamed == out.tolist() and len(out) == 12
        assert port_flash.flash_attention.launches > 0
        assert port_paged.paged_attention.launches > 0
        assert port_flash.flash_attention_plain.launches == 0
        assert port_paged.paged_attention_plain.launches == 0
    finally:
        eng.stop()
