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
output, 1e-4 abs on every output of the LSTM scan (f32 math, sums in
another order than the plain version's matmul), two launches bit-equal,
a partial last row block, and a shape the layout planner refuses raising
through the wrapper. The LSTM backward: 1e-4 abs on dxproj, dh0 and dc0,
and 1e-4 of the largest entry on dU and dp, which sum N*T products; two
launches bit-equal. A full-width char-RNN fit on the card against
the same fit on the CPU: see that test. The SGNS step (K3): within 1e-5
of the largest entry of each table's update of the plain step run in
f64 on the same inputs (K3 sums each row's hits in batch order in f32;
the plain step in f32 on the card adds with atomics onto the tables and
drifts by more than that at ~190 hits per row), rows no live pair
touches bit-equal, two launches bit-equal, and a first call's scratch
far below one [V, D] table; a word2vec fit on the card (CUDA graph
replays) against the same fit on the CPU with the same draws, the
graph's draws against the eager draws (bit-equal), graph-replayed chunks
against the eager loop within 1e-5 of each table's change, and K3's
launch counter under capture and replay: see those tests. K5 (flash
attention with a key bias and an offset): 1e-4 abs on O and lse in f32,
2e-2 on O and 1e-3 on lse in bf16, and the rows with no visible key
exactly O = 0, lse = -inf; the in-process 4-shard ring
against the plain full attention at the same bars; ``FlashBlockFn``'s
gradients against autograd through the plain version at 1e-4 of the
largest entry, and the blocked backward on the card against the CPU at
the same bar, zero on an all-masked row. K4 and K5 share one kernel
template (``csrc/flash_fwd.cuh``): they give the same bits at offset 0
(causal) or T (full), misaligned bf16 views the same bits as contiguous
copies, and the built libraries' SASS holds HGMMA, LDGSTS and the f32
kernels' TF32 HMMA. K6 at contexts on either side of its split
boundaries, in every q/kv dtype pair and head size: 1e-3 abs, two
launches bit-equal. K7 (the flash backward) against its plain version,
``flash_block_bwd``, on the same card inputs: 1e-2 of the largest entry
of each gradient in bf16 (P and dS rounded to bf16 for their products)
and 1e-4 in f32 (3xTF32), an all-masked batch row exactly zero,
masked keys' dK and dV exactly zero (whole key tiles masked too), with
and without an lse cotangent, two launches bit-equal, its bf16 kernels
on wgmma and all on cp.async (SASS); a TransformerLM
step on the card puts nonzero gradients into Wq, Wk and Wv and agrees
with the same step on the CPU (see that test for its bars); remat
``dots``/``block`` on the card give the no-remat forward bit for bit and
its gradients within 1e-2, with K4 launched once (``dots``) or twice
(``block``) per layer; bf16 loss-scaled steps grow the scale and skip a
step with a non-finite gradient. Sequence-parallel training on a world-1
NCCL group: the ring step (K5, K7) and the Ulysses step (K4, K7), strict
f32, within 1e-4 of the dense step on the CPU (loss relative, each
gradient leaf of its largest entry); the 4-shard ring driven in one
process, forward and backward through K5 and K7 with the lse cotangent,
within 1e-2 of each gradient's largest entry of the same chain through
the plain versions, masked keys' dK and dV exactly 0. BERT on the card
(K5 at offset T with the key mask, K7), strict f32: an MLM step's loss
and gradients and a fine-tune step's within 1e-4 of the CPU's, an
all-pad row's encoding too, ``encoder_lr_scale=0`` keeping the encoder.
The int8 ``/predict`` path: ``int8_matmul`` (torch._int_mm on operands
padded to its shape rules) bit-equal in int32 to the exact CPU product at
the char-RNN head's and the lowprec MLP's shapes, M = 1 and N = 10
included; a quantized char-RNN on the card against the CPU at the
per-code bar (one-step tie flips in at most 1e-4 of the head's input
codes, the outputs within 1e-5 plus what the flips explain); and
``retire`` freeing at least the record's ``param_bytes`` of device
memory. The CNN path: LeNet-5's and AlexNet's ``output`` on the card
within 1e-4 of the largest probability of the CPU's on the same weights;
cuDNN and cuBLAS without TF32 after an entry point (the flags, and a
3x3x256 convolution within 1e-5 of f64); the Embedding -> LSTM net's
``fit`` through K1 and K2 once each, never their plain versions, within
1e-4 of the CPU's step.
The ComputationGraph: the seq2seq graph's fit launches K1 and K2
twice each (one LSTM vertex each) and their plain versions never, and
its first step agrees with the CPU's within 1e-4 of each vertex's
largest entry; ResNet-50's first step at 224: the loss and BN's state
at 1e-4, the params against the f64 step: the card's worst vertex
within four times the CPU's own worst f32 vertex (see that test).
The training runtime: a batch staged by the input pipeline's stager
while a sleep kernel holds the consumer's stream equals the host batch,
50 rounds with the caller's pinned batch overwritten right after
``put``; the native feed through ``InputPipeline.from_native`` equals
the plain version's batches; a small char-RNN killed at step 5 and
resumed through the pipeline ends torch.equal to an uninterrupted run.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_attention as port_flash
from deeplearning4j_tpu_torch.ops import lstm_scan as port_lstm
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves, tree_map
from deeplearning4j_tpu_torch.ops import paged_attention as port_paged
from deeplearning4j_tpu_torch.ops import sgns as port_sgns


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
@pytest.mark.parametrize("t,d", [(8, 16), (96, 32), (192, 64), (130, 128),
                                 (1, 64), (63, 32), (65, 16), (127, 128),
                                 (129, 64), (300, 128), (300, 16)])
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


def _split_case(seed, contexts, h, hd, bt, m):
    """One lane per context (tokens 0 .. context - 1 visible), each on
    its own arena blocks (from 1; block 0 is trash)."""
    rng = np.random.default_rng(seed)
    s = len(contexts)
    n_blocks = s * m
    q = rng.standard_normal((s, h, hd)).astype(np.float32)
    ck = rng.standard_normal((n_blocks + 1, bt, h, hd)).astype(np.float32)
    cv = rng.standard_normal((n_blocks + 1, bt, h, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_blocks + 1))
    pos = np.array(contexts, np.int32) - 1
    tables = np.zeros((s, m), np.int32)
    for i in range(s):
        used = int(pos[i]) // bt + 1
        tables[i, :used] = perm[i * m:i * m + used]
    return q, ck, cv, tables, pos


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_paged_kernel_at_split_boundaries_on_card(hd, q_dtype, kv_dtype):
    """K6 cuts a lane's context into splits of SPLIT_TOKENS tokens: lanes
    that end one token before, on and one after a split boundary (the
    first and the second), at a single token and at the full window,
    against the plain version at 1e-3; two launches give the same bits
    (the partials merge in split order), and a poisoned trash block moves
    no output bit."""
    dev = _need_card()
    st, bt = port_paged.SPLIT_TOKENS, 16
    m = (2 * st) // bt + 4
    contexts = [st - 1, st, st + 1, 2 * st - 1, 2 * st, 2 * st + 1, 1,
                m * bt]
    q, ck, cv, tables, pos = _split_case(hd + 1, contexts, 3, hd, bt, m)
    qt = _port(q, dev, q_dtype)
    ckt, cvt = (_port(a, dev, kv_dtype) for a in (ck, cv))
    tt, pt = torch.from_numpy(tables).to(dev), torch.from_numpy(pos).to(dev)
    out = port_paged.paged_attention(qt, ckt, cvt, tt, pt)
    again = port_paged.paged_attention(qt, ckt, cvt, tt, pt)
    ref = port_paged.paged_attention_plain(qt, ckt, cvt, tt, pt)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() < 1e-3
    assert torch.equal(out, again)
    ckt[0], cvt[0] = 1e6, -1e6
    assert torch.equal(out, port_paged.paged_attention(qt, ckt, cvt, tt, pt))


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

    for res in build.build(["flash_attention", "paged_attention",
                            "lstm_scan", "lstm_scan_bwd", "sgns",
                            "flash_bwd"]):
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


@pytest.mark.gpu
def test_paged_kernel_f32_queries_over_a_bf16_arena_on_card():
    """K6's f32-query, bf16-arena instantiation (an f32 model under
    DL4J_TPU_SERVE_KV_DTYPE=bf16) at 64 lanes of mixed contexts: within
    1e-3 of the plain version, two launches bit-equal, a poisoned trash
    block moving no output bit."""
    dev = _need_card()
    q, ck, cv, tables, pos = _arena_case(5, s=64, h=4, hd=64, bt=16, m=40)
    qt = _port(q, dev)
    ckt, cvt = (_port(a, dev, torch.bfloat16) for a in (ck, cv))
    tt, pt = torch.from_numpy(tables).to(dev), torch.from_numpy(pos).to(dev)
    before = port_paged.paged_attention.launches
    out = port_paged.paged_attention(qt, ckt, cvt, tt, pt)
    again = port_paged.paged_attention(qt, ckt, cvt, tt, pt)
    ref = port_paged.paged_attention_plain(qt, ckt, cvt, tt, pt)
    torch.cuda.synchronize()
    assert port_paged.paged_attention.launches == before + 2
    assert (out - ref).abs().max().item() < 1e-3
    assert torch.equal(out, again)
    ckt[0], cvt[0] = 1e6, -1e6
    assert torch.equal(out, port_paged.paged_attention(qt, ckt, cvt, tt, pt))


def _decode_case(dev, dtype_policy="strict", seed=2):
    """A small LM on the card and an arena holding three admitted
    prompts (tables grown 8 positions ahead): (lm, arena, tok, pos,
    tables)."""
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from deeplearning4j_tpu_torch.serving.paged import paged_admit

    cfg = TransformerConfig(vocab_size=64, d_model=64, n_layers=2,
                            n_heads=4, d_ff=128, max_len=128, seed=seed,
                            dtype_policy=dtype_policy)
    lm = TransformerLM(cfg, device=dev)
    bt, m = 16, 8
    shape = (2, 40, bt, 4, 16)
    arena = {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}
    prompts = [[3, 1, 4, 1, 5], list(range(1, 40)), [9] * 17]
    tables = np.zeros((3, m), np.int32)
    tok = np.zeros((3,), np.int32)
    pos = np.zeros((3,), np.int32)
    nxt = 1
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            nb = (len(p) - 1 + 8) // bt + 1
            tables[i, :nb] = range(nxt, nxt + nb)
            nxt += nb
            paged_admit(lm.compute_params, arena,
                        torch.tensor([p], device=dev),
                        torch.from_numpy(tables[i]).to(dev), cfg)
            tok[i], pos[i] = p[-1], len(p) - 1
    to = lambda a: torch.from_numpy(a).to(dev)
    return lm, arena, to(tok), to(pos), to(tables)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["strict", "performance"])
def test_k_step_tick_equals_single_ticks_on_card(policy):
    """A 4-step tick against 4 single ticks from the same arena, greedy
    and sampled lanes (each generator seeded alike): the same tokens and
    the same arena bits; K6 once per layer per step."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.serving.paged import _paged_tick_for

    lm, arena, tok, pos, tables = _decode_case(dev, policy)
    temps = [0.0, 0.8, 0.0]
    gens = lambda: [None, torch.Generator(device=dev).manual_seed(5), None]
    two = {n: v.clone() for n, v in arena.items()}
    with torch.inference_mode():
        before = port_paged.paged_attention.launches
        _, many = _paged_tick_for(lm.cfg, 4)(
            lm.compute_params, arena, tok, pos, tables, temps, gens())
        assert port_paged.paged_attention.launches == before + 4 * 2
        g, t, p, ones = gens(), tok, pos, []
        for _ in range(4):
            _, one = _paged_tick_for(lm.cfg, 1)(
                lm.compute_params, two, t, p, tables, temps, g)
            t, p = one[:, 0], p + 1
            ones.append(one[:, 0])
    assert torch.equal(many, torch.stack(ones, 1))
    for n in ("k", "v"):
        assert torch.equal(arena[n], two[n])


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["strict", "performance"])
def test_verify_greedy_equals_single_ticks_on_card(policy):
    """The speculative verify of k+1 tokens (the greedy stream, with a
    wrong proposal in the middle) gives, at every position, the argmax a
    greedy single tick gives after the same tokens: K6 (k+1) x layers
    times."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.serving.paged import _paged_tick_for
    from deeplearning4j_tpu_torch.serving.speculate import _verify_for

    lm, arena, tok, pos, tables = _decode_case(dev, policy, seed=4)
    k = 4
    two = {n: v.clone() for n, v in arena.items()}
    with torch.inference_mode():
        t, p, stream = tok, pos, []
        for _ in range(k + 1):
            _, one = _paged_tick_for(lm.cfg, 1)(
                lm.compute_params, two, t, p, tables, [0.0] * 3,
                [None] * 3)
            t, p = one[:, 0], p + 1
            stream.append(one[:, 0])
        greedy = torch.stack(stream, 1)                 # [3, k+1]
        toks = torch.cat([tok.long()[:, None], greedy[:, :k]], 1)
        toks[1, 3] = (toks[1, 3] + 1) % 64              # a rejected one
        before = port_paged.paged_attention.launches
        _, got = _verify_for(lm.cfg, k)(lm.compute_params, arena, toks,
                                            pos, tables)
        assert port_paged.paged_attention.launches == before + (k + 1) * 2
    # every position up to the wrong proposal equals the greedy stream
    assert torch.equal(got[0], greedy[0]) and torch.equal(got[2], greedy[2])
    assert torch.equal(got[1, :3], greedy[1, :3])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "layers:1"])
def test_speculative_engine_equals_target_greedy_on_card(mode, monkeypatch):
    """DL4J_TPU_SERVE_SPEC through the engine on the card: the greedy
    transcripts equal the paged engine's, speculative rounds ran, and
    no plain attention version ran."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine
    from deeplearning4j_tpu_torch.serving.speculate import (
        SpeculativeDecoder,
    )

    lm = TransformerLM(TransformerConfig(
        vocab_size=64, d_model=64, n_layers=2, n_heads=4, d_ff=128,
        max_len=128, dtype_policy="performance"), device=dev)
    prompts = [[1, 2, 3, 4, 5] * 7, [7, 8, 9], list(range(2, 30))]
    monkeypatch.delenv("DL4J_TPU_SERVE_SPEC", raising=False)
    eng = ServingEngine(lm, kv_blocks=32, device=dev)
    try:
        base = [eng.generate([p], 20, temperature=0.0)[0].tolist()
                for p in prompts]
    finally:
        eng.stop()
    monkeypatch.setenv("DL4J_TPU_SERVE_SPEC", mode)
    eng = ServingEngine(lm, kv_blocks=32, device=dev)
    try:
        assert isinstance(eng.decoder, SpeculativeDecoder)
        port_paged.paged_attention_plain.launches = 0
        port_flash.flash_attention_plain.launches = 0
        futs = [eng.decoder.submit(p, 20, temperature=0.0) for p in prompts]
        got = [f.result(timeout=300).tolist() for f in futs]
        assert eng.decoder.spec_rounds > 0
        assert port_paged.paged_attention_plain.launches == 0
        assert port_flash.flash_attention_plain.launches == 0
    finally:
        eng.stop()
    assert got == base


def _lstm_args(seed, n, t, h, dev, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(0, 0.5, (n, t, 4 * h)), rng.normal(0, 0.3, (h, 4 * h))
            / np.sqrt(h / 8), rng.normal(0, 0.1, (3, h)),
            rng.normal(0, 0.2, (n, h)), rng.normal(0, 0.2, (n, h)))
    return [_port(a.astype(np.float32), dev, dtype) for a in arrs]


@pytest.mark.gpu
@pytest.mark.parametrize("emit_cs", [False, True])
@pytest.mark.parametrize("n,t,h", [(1, 8, 200), (3, 13, 16), (64, 100, 200),
                                   (70, 9, 300), (5, 20, 1000)])
def test_lstm_scan_kernel_matches_plain_on_card(n, t, h, emit_cs):
    dev = _need_card()
    args = _lstm_args(n + t + h, n, t, h, dev)
    before = port_lstm.lstm_scan.launches
    out = port_lstm.lstm_scan(*args, emit_cs=emit_cs)
    torch.cuda.synchronize()
    assert port_lstm.lstm_scan.launches == before + 1
    ref = port_lstm.lstm_scan_plain(*args, emit_cs=emit_cs)
    assert (out[3] is None) == (not emit_cs)
    for a, b in zip(out, ref):
        if a is not None:
            assert a.shape == b.shape and a.dtype == torch.float32
            assert (a - b).abs().max().item() < 1e-4


@pytest.mark.gpu
def test_lstm_scan_takes_bf16_and_strided_xproj():
    """bf16 inputs (the performance policy) are computed in f32; an xproj
    view with a non-unit row stride is read through its strides."""
    dev = _need_card()
    x, u, p, h0, c0 = _lstm_args(1, 4, 12, 64, dev)
    wide = torch.zeros((4, 12, 512), device=dev)
    wide[..., :256] = x
    view = wide[..., :256]
    assert view.stride(1) == 512
    ref = port_lstm.lstm_scan_plain(x, u, p, h0, c0)
    out = port_lstm.lstm_scan(view, u, p, h0, c0)
    assert (out[0] - ref[0]).abs().max().item() < 1e-4
    bf = [a.to(torch.bfloat16) for a in (x, u, p, h0, c0)]
    ref_bf = port_lstm.lstm_scan_plain(*(a.float() for a in bf))
    out_bf = port_lstm.lstm_scan(*bf)
    assert out_bf[0].dtype == torch.float32
    assert (out_bf[0] - ref_bf[0]).abs().max().item() < 1e-4


@pytest.mark.gpu
def test_lstm_scan_refuses_what_the_kernel_does_not_take():
    dev = _need_card()
    x, u, p, h0, c0 = _lstm_args(2, 2, 8, 16, dev)
    with pytest.raises(ValueError, match="expected"):
        port_lstm.lstm_scan(x, u[:, :32], p, h0, c0)
    # H=4100: 257 units per CTA at 16 CTAs per cluster, 513 at 8; the
    # planner finds no layout and the wrapper raises with its reason
    big = 4100
    zeros = [torch.zeros(s, device=dev) for s in (
        (1, 8, 4 * big), (big, 4 * big), (3, big), (1, big), (1, big))]
    with pytest.raises(ValueError, match="no cluster layout"):
        port_lstm.lstm_scan(*zeros)


@pytest.mark.gpu
@pytest.mark.parametrize("emit_cs", [False, True])
@pytest.mark.parametrize("n,t,h", [(1, 8, 200), (64, 100, 200),
                                   (32, 50, 200), (70, 9, 300),
                                   (5, 20, 1000)])
def test_lstm_scan_two_launches_give_the_same_bits_on_card(n, t, h,
                                                           emit_cs):
    """K1 sums its k shares in a fixed order: no atomics, the same bits."""
    dev = _need_card()
    args = _lstm_args(n + t + h, n, t, h, dev)
    out = port_lstm.lstm_scan(*args, emit_cs=emit_cs)
    again = port_lstm.lstm_scan(*args, emit_cs=emit_cs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again)
               if a is not None)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [37, 97])
def test_lstm_scans_with_a_partial_row_block_on_card(n):
    """A batch whose last row block is partial: the rows past N are zeros
    in the cluster's tiles and are never written out."""
    dev = _need_card()
    lib = port_lstm.build.load("lstm_scan", port_lstm._SIGNATURE)
    pl = port_lstm._card_plan(lib, "lstm_scan_fwd_clusters", n, 12, 200,
                              False, dev)
    assert n % pl.rows != 0
    args = _lstm_args(n, n, 12, 200, dev)
    out = port_lstm.lstm_scan(*args, emit_cs=True)
    ref = port_lstm.lstm_scan_plain(*args, emit_cs=True)
    for a, b in zip(out, ref):
        assert (a - b).abs().max().item() < 1e-4
    bwd = _bwd_args(n, n, 12, 200, dev)
    lib = port_lstm.build.load("lstm_scan_bwd", port_lstm._BWD_SIGNATURE)
    pl = port_lstm._card_plan(lib, "lstm_scan_bwd_clusters", n, 12, 200,
                              True, dev)
    assert n % pl.rows != 0
    got = port_lstm.lstm_scan_bwd(*bwd)
    assert max(_bwd_errors(got, port_lstm.lstm_scan_bwd_plain(*bwd))) < 1e-4


@pytest.mark.gpu
def test_multilayer_network_on_the_card_goes_through_k1():
    """A char-RNN on the card: output routes every LSTM layer through the
    kernel (T >= 8), agrees with the same net on the CPU, and /predict
    answers through the batcher; the plain version never runs on the
    card."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_conf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine

    conf = char_rnn_conf(12, lstm_size=32, num_layers=2)
    net = MultiLayerNetwork(conf, device=dev).init(input_shape=(1, 12))
    cpu = MultiLayerNetwork(conf, device="cpu")
    cpu.init(input_shape=(1, 12))
    cpu.params = [{k: v.cpu() for k, v in p.items()} for p in net.params]
    x = np.eye(12, dtype=np.float32)[
        np.random.default_rng(0).integers(0, 12, (5, 16))]
    ref = cpu.output(x)  # the plain scan, on the CPU
    port_lstm.lstm_scan.launches = port_lstm.lstm_scan_plain.launches = 0
    out = net.output(x)
    assert out.device.type == "cuda"
    assert port_lstm.lstm_scan.launches == 2
    assert port_lstm.lstm_scan_plain.launches == 0
    assert (out.cpu() - ref).abs().max().item() < 1e-5
    eng = ServingEngine(model=net, device=dev)
    try:
        got = eng.predict(x[:2])
        assert np.abs(got - out[:2].cpu().numpy()).max() < 1e-5
        assert port_lstm.lstm_scan.launches > 2
        assert port_lstm.lstm_scan_plain.launches == 0
    finally:
        eng.stop()


def _bwd_args(seed, n, t, h, dev):
    x, u, p, h0, c0 = _lstm_args(seed, n, t, h, dev)
    hs, _, _, cs = port_lstm.lstm_scan(x, u, p, h0, c0, emit_cs=True)
    rng = np.random.default_rng(seed + 1)
    cot = [_port(rng.standard_normal(s).astype(np.float32), dev)
           for s in ((n, t, h), (n, h), (n, h))]
    return (x, u, p, h0, c0, cs, hs, *cot)


def _bwd_errors(out, ref):
    """abs error on dxproj, dh0, dc0; error relative to the largest entry
    on dU and dp."""
    errs = []
    for i, (a, b) in enumerate(zip(out, ref)):
        e = (a - b).abs().max().item()
        if i in (1, 2):
            e /= max(b.abs().max().item(), 1e-30)
        errs.append(e)
    return errs


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,h", [(1, 8, 200), (32, 50, 200), (3, 13, 16),
                                   (70, 9, 300), (64, 100, 200),
                                   (32, 128, 128), (5, 12, 270)])
def test_lstm_scan_bwd_kernel_matches_plain_on_card(n, t, h):
    """(5, 12, 270): 17 units per CTA, the last CTA of each cluster holds
    15 (H % 16 != 0); (70, 9, 300): 16-row blocks, the last partial;
    (32, 128, 128): 16 ranges of rows in the dU product."""
    dev = _need_card()
    args = _bwd_args(n + t + h, n, t, h, dev)
    before = port_lstm.lstm_scan_bwd.launches
    out = port_lstm.lstm_scan_bwd(*args)
    torch.cuda.synchronize()
    assert port_lstm.lstm_scan_bwd.launches == before + 1
    ref = port_lstm.lstm_scan_bwd_plain(*args)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
    assert max(_bwd_errors(out, ref)) < 1e-4
    again = port_lstm.lstm_scan_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.gpu
def test_lstm_scan_fn_gradients_match_autograd_through_plain_on_card():
    dev = _need_card()
    args = [a.requires_grad_() for a in _lstm_args(7, 4, 20, 64, dev)]
    w = [torch.randn(s, device=dev, generator=torch.Generator(
        device=dev).manual_seed(i)) for i, s in enumerate(
        ((4, 20, 64), (4, 64), (4, 64)))]
    fwd, bwd = port_lstm.lstm_scan.launches, port_lstm.lstm_scan_bwd.launches
    got = torch.autograd.grad(sum((o * ww).sum() for o, ww in zip(
        port_lstm.LstmScanFn.apply(*args), w)), args)
    assert (port_lstm.lstm_scan.launches, port_lstm.lstm_scan_bwd.launches) \
        == (fwd + 1, bwd + 1)
    want = torch.autograd.grad(sum((o * ww).sum() for o, ww in zip(
        port_lstm.lstm_scan_plain(*args)[:3], w)), args)
    assert max(_bwd_errors(got, want)) < 1e-4


@pytest.mark.gpu
def test_lstm_scan_bwd_refuses_what_the_kernel_does_not_take():
    dev = _need_card()
    args = list(_bwd_args(4, 2, 8, 16, dev))
    args[5] = args[5][:4]  # cs cut short
    with pytest.raises(ValueError, match="cs"):
        port_lstm.lstm_scan_bwd(*args)


@pytest.mark.gpu
def test_full_width_fit_on_the_card_matches_the_cpu():
    """One fit of the char-RNN at full width (vocab 80, 2 x 200, TBPTT
    50, batch 32, T=100) on the card and on the CPU from the same
    weights: K1 and K2 launch 4 times (2 windows x 2 layers), the plain
    versions never, and the two window losses agree within 1e-4 and the
    params within 1e-3 (RMSProp's first steps divide a gradient by
    sqrt(cache + eps), so an entry near zero moves by lr * dg / 1e-4)."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_conf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresIterationListener,
    )

    conf = char_rnn_conf(80, lstm_size=200, num_layers=2, tbptt_length=50)
    card = MultiLayerNetwork(conf, device=dev).init(input_shape=(1, 80))
    cpu = MultiLayerNetwork(conf, device="cpu").init(input_shape=(1, 80))
    cpu.params = [{k: v.cpu() for k, v in p.items()} for p in card.params]
    cpu.updater_state = cpu.updater.init(cpu.params)
    ids = np.random.default_rng(0).integers(0, 80, (32, 101))
    eye = np.eye(80, dtype=np.float32)
    x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]
    cols = []
    for net in (card, cpu):
        cols.append(CollectScoresIterationListener())
        net.set_listeners(cols[-1])
    for fn in (port_lstm.lstm_scan, port_lstm.lstm_scan_plain,
               port_lstm.lstm_scan_bwd, port_lstm.lstm_scan_bwd_plain):
        fn.launches = 0
    card.fit(x, y)
    torch.cuda.synchronize()
    assert (port_lstm.lstm_scan.launches, port_lstm.lstm_scan_bwd.launches,
            port_lstm.lstm_scan_plain.launches,
            port_lstm.lstm_scan_bwd_plain.launches) == (4, 4, 0, 0)
    cpu.fit(x, y)
    for (_, a), (_, b) in zip(*(c.scores for c in cols)):
        assert abs(a - b) < 1e-4
    for pa, pb in zip(card.params, cpu.params):
        for k in pa:
            assert (pa[k].cpu() - pb[k]).abs().max().item() < 1e-3, k


def _sgns_args(seed, v, d, b, k1, dev, scale=0.1, dead=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    syn0 = torch.randn((v, d), generator=g, device=dev) * scale
    syn1neg = torch.randn((v, d), generator=g, device=dev) * scale
    cx = torch.randint(0, v, (b,), generator=g, device=dev)
    tgt = torch.randint(0, v, (b, k1), generator=g, device=dev)
    labels = torch.zeros((b, k1), device=dev)
    labels[:, 0] = 1.0
    live = torch.ones((b, k1), device=dev)
    if dead:
        live = (torch.rand((b, k1), generator=g, device=dev) > 0.3).float()
        live[::7] = 0.0
    return syn0, syn1neg, cx, tgt, labels, live


@pytest.mark.gpu
@pytest.mark.parametrize("v,d,b,k1,scale,dead", [
    (71290, 128, 2048, 6, 0.1, False), (100000, 100, 1024, 6, 0.1, False),
    (64, 128, 2048, 6, 0.1, False), (5000, 128, 2048, 6, 3.0, False),
    (5000, 128, 2048, 6, 0.1, True), (300, 20, 33, 3, 0.5, True),
    (1000, 300, 1, 6, 0.1, False), (1000, 512, 64, 2, 0.1, False),
    (3, 128, 2048, 6, 0.1, False), (1, 36, 500, 6, 0.1, True)],
    ids=["smoke", "hot-class", "collide", "saturated", "dead", "ragged",
         "b1-d300", "d512", "hot-v3", "one-row-d36"])
def test_sgns_kernel_matches_plain_on_card(v, d, b, k1, scale, dead):
    """K3 against the plain step in f64 within 1e-5 of each table's
    update, untouched rows bit-equal, and two launches bit-equal (every
    row's sum in batch order, no float atomics). V=64 gives ~190 hits a
    syn1neg row, V=3 ~4,000 and V=1 every hit one row (the owner CTA's
    scan in several rounds)."""
    dev = _need_card()
    syn0, syn1neg, cx, tgt, lbl, live = _sgns_args(v + d, v, d, b, k1, dev,
                                                   scale, dead)
    k0, k1_ = syn0.clone(), syn1neg.clone()
    before = port_sgns.sgns_step.launches
    alpha = torch.tensor(0.025, device=dev)
    port_sgns.sgns_step(k0, k1_, cx, tgt, lbl, live, alpha)
    torch.cuda.synchronize()
    assert port_sgns.sgns_step.launches == before + 1
    p0, p1 = syn0.double(), syn1neg.double()
    port_sgns.sgns_step_plain(p0, p1, cx, tgt, lbl.double(), live.double(),
                              alpha)
    touched = (live.sum(1) > 0, live > 0)
    for got, want, old, rows in ((k0, p0, syn0, cx[touched[0]]),
                                 (k1_, p1, syn1neg, tgt[touched[1]])):
        upd = (want - old.double()).abs().max().item()
        assert (got.double() - want).abs().max().item() <= 1e-5 * upd
        hit = torch.zeros(len(old), dtype=torch.bool, device=dev)
        hit[rows] = True
        assert torch.equal(got[~hit], old[~hit])
    again0, again1 = syn0.clone(), syn1neg.clone()
    port_sgns.sgns_step(again0, again1, cx, tgt, lbl, live, 0.025)
    assert torch.equal(again0, k0) and torch.equal(again1, k1_)


@pytest.mark.gpu
def test_sgns_allocates_no_table_sized_buffer_on_card():
    """A first call on a fresh stream allocates its scratch, O(B*D + V):
    far less than one [V, D] table (the atomic design's delta buffers were
    two)."""
    dev = _need_card()
    v, d, b, k1 = 71290, 128, 2048, 6
    args = _sgns_args(1, v, d, b, k1, dev)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        port_sgns.sgns_step(*args, 0.025)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated(dev) - before
    assert 0 < grown < v * d * 4
    sizes = port_sgns.workspace_sizes(v, d, b, k1)
    assert grown >= sum(4 * n for n, _ in sizes.values())


@pytest.mark.gpu
def test_sgns_refuses_what_the_kernel_does_not_take():
    dev = _need_card()
    syn0, syn1neg, cx, tgt, lbl, live = _sgns_args(0, 50, 16, 8, 3, dev)
    with pytest.raises(ValueError, match="int64"):
        port_sgns.sgns_step(syn0, syn1neg, cx.int(), tgt, lbl, live, 0.1)
    with pytest.raises(ValueError, match="D=600"):
        big = torch.zeros((50, 600), device=dev)
        port_sgns.sgns_step(big, big.clone(), cx, tgt, lbl, live, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        port_sgns.sgns_step(syn0, syn1neg, cx, tgt.t().contiguous().t(),
                            lbl, live, 0.1)


@pytest.mark.gpu
def test_word2vec_fit_on_the_card_matches_the_cpu():
    """Skip-gram with HS and 5 negatives at D=128 on a small Zipf corpus,
    on the CPU and on the card with the same draws (numpy, per batch
    index; the card replays them from the device, by the index its graphs
    read there): the card's chunks run as CUDA graph replays, K3 launches
    once per batch, its plain version never, and the three tables agree
    within 1e-5 abs (HS's index_add_ adds with atomics in another order;
    the tables' entries are of order 0.01-0.1)."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, replay_draw

    rng = np.random.default_rng(0)
    toks = [[f"w{int(x)}" for x in rng.zipf(1.2, 40) if x < 3000]
            for _ in range(400)]
    draws = {}
    cpu = Word2Vec(layer_size=128, window=5, negative=5, batch_size=512,
                   seed=1, device="cpu")
    cpu.build_vocab(toks)
    table = cpu.lookup_table.table

    def draw(i):
        draws[i] = table[np.random.default_rng(i).integers(
            0, len(table), (512, 5))].astype(np.int64)
        return torch.from_numpy(draws[i])
    cpu.fit_tokens(toks, draw=draw)
    n_batches = len(draws)
    assert n_batches > 10 and sorted(draws) == list(range(n_batches))
    card = Word2Vec(layer_size=128, window=5, negative=5, batch_size=512,
                    seed=1, device=dev)
    card.build_vocab(toks)
    negatives = torch.from_numpy(np.stack([draws[i]
                                           for i in range(n_batches)]))
    for fn in (port_sgns.sgns_step, port_sgns.sgns_step_plain):
        fn.launches = 0
    card.fit_tokens(toks, draw=replay_draw(negatives.to(dev)))
    assert (port_sgns.sgns_step.launches,
            port_sgns.sgns_step_plain.launches) == (n_batches, 0)
    st = card.fit_stats
    assert st["graph_replays"] >= 1 and st["graph_captures"] >= 1
    for name in ("syn0", "syn1", "syn1neg"):
        a = getattr(card.lookup_table, name)
        b = getattr(cpu.lookup_table, name)
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() < 1e-5, name


def _chunk_case(seed, dev, v=3000, vh=2999, d=128, nb=7, b=512, k=5,
                width=12):
    """Tables, Huffman paths and nb batches of pairs (the last partly
    padded) on the card, as skipgram_batches takes them."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    tables = tuple(t((rng.standard_normal((n, d)) * 0.1).astype(np.float32))
                   for n in (v, vh, v))
    huffman = (t(rng.integers(0, vh, (v, width))),
               t(rng.integers(0, 2, (v, width)).astype(np.float32)),
               t((rng.random((v, width)) < 0.7).astype(np.float32)))
    zipf = lambda n: np.minimum(rng.zipf(1.3, n), v) - 1
    cens, cxs = (t(zipf(nb * b).reshape(nb, b)) for _ in range(2))
    plive = np.ones((nb, b), np.float32)
    plive[-1, b // 3:] = 0.0
    alphas = t(np.linspace(0.025, 0.02, nb).astype(np.float32))
    negatives = t(zipf(nb * b * k).reshape(nb, b, k))
    return tables, huffman, cens, cxs, t(plive), alphas, negatives


def _changes_agree(got, want, before, tol=1e-5):
    for a, b, o in zip(got, want, before):
        upd = (b.double() - o.double()).abs().max().item()
        assert (a.double() - b.double()).abs().max().item() <= tol * upd


@pytest.mark.gpu
def test_graph_draws_equal_the_eager_draws_on_card():
    """unigram_draw's generator registered with a captured graph: two
    replays of three draws give the eager loop's six draws from the same
    seed."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.nlp.word2vec import unigram_draw

    table = torch.arange(1000, device=dev) * 7
    eager = unigram_draw(table, 5, 512,
                         torch.Generator(device=dev).manual_seed(3))
    want = [eager(i) for i in range(6)]
    draw = unigram_draw(table, 5, 512,
                        torch.Generator(device=dev).manual_seed(3))
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(draw.generator)
    out = torch.zeros((3, 512, 5), dtype=torch.int64, device=dev)
    stream = torch.cuda.Stream(dev)
    with torch.cuda.graph(graph, stream=stream):
        for j in range(3):
            out[j].copy_(draw(j))
    got = []
    for _ in range(2):
        graph.replay()
        got.extend(out.clone())
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["replayed", "unigram", "hs-only"],
                         ids=["replayed-negatives", "unigram-generator",
                              "hs-only"])
def test_graph_replayed_chunks_match_the_eager_loop_on_card(mode):
    """Seven batches as graph replays of a 4-batch chunk and a 3-batch
    tail (two captures) against the eager loop of skipgram_step on copies
    of the same tables with the same draws (or none: HS only): within
    1e-5 of each table's change (HS's index_add_ adds with atomics). K3's
    counter: the captures count nothing, each replay its chunk's
    batches."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.nlp.word2vec import (
        SkipgramGraphs,
        replay_draw,
        skipgram_batches,
        unigram_draw,
    )

    tables, huffman, cens, cxs, plive, alphas, negatives = _chunk_case(
        5, dev)
    nb, b, k = negatives.shape
    if mode == "hs-only":
        tables, k = tables[:2] + (None,), 0
    before = [x.clone() for x in tables if x is not None]
    eager_tables = [None if x is None else x.clone() for x in tables]

    def make_draw():
        if mode == "replayed":
            return replay_draw(negatives)
        if mode == "unigram":
            return unigram_draw(torch.arange(2999, device=dev), k, b,
                                torch.Generator(device=dev).manual_seed(9))
        return None
    skipgram_batches(eager_tables, huffman, cens, cxs, plive, alphas,
                     negative=k, draw=make_draw())
    port_sgns.sgns_step.launches = 0
    runner = SkipgramGraphs(tables, huffman, b, k, make_draw())
    for s0, s1 in ((0, 4), (4, 7)):
        runner.run(cens[s0:s1], cxs[s0:s1], plive[s0:s1], alphas[s0:s1],
                   s0)
    torch.cuda.synchronize()
    assert (runner.captures, runner.replays) == (2, 2)
    assert port_sgns.sgns_step.launches == (nb if k else 0)
    _changes_agree(tables[:len(before)], eager_tables, before)


@pytest.mark.gpu
def test_graph_replays_count_k3_launches_on_card():
    """A 3-batch chunk replayed four times adds 12 to K3's counter and
    nothing to the plain version's; the capture added nothing to either
    (it launched nothing) and counted its three calls as captured."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.nlp.word2vec import (
        SkipgramGraphs,
        replay_draw,
    )

    tables, huffman, cens, cxs, plive, alphas, negatives = _chunk_case(
        6, dev, nb=3)
    runner = SkipgramGraphs(tables, huffman, cens.shape[1],
                            negatives.shape[2], replay_draw(negatives))
    counts = (port_sgns.sgns_step.launches,
              port_sgns.sgns_step_plain.launches,
              port_sgns.sgns_step.captured)
    runner.run(cens, cxs, plive, alphas)
    assert (port_sgns.sgns_step.launches, port_sgns.sgns_step.captured) == \
        (counts[0] + 3, counts[2] + 3)
    for _ in range(3):
        runner.run(cens, cxs, plive, alphas)
    torch.cuda.synchronize()
    assert runner.captures == 1 and runner.replays == 4
    assert port_sgns.sgns_step.launches == counts[0] + 12
    assert port_sgns.sgns_step_plain.launches == counts[1]


def _ext_case(seed, n, tq, tk, h, d, dev, dtype, masked):
    rng = np.random.default_rng(seed)
    q = _port(rng.standard_normal((n, tq, h, d)).astype(np.float32), dev,
              dtype)
    k, v = (_port(rng.standard_normal((n, tk, h, d)).astype(np.float32),
                  dev, dtype) for _ in range(2))
    km = None
    if masked:
        km = (rng.random((n, tk)) < 0.8).astype(np.float32)
        km[-1] = 0.0  # a batch row with every key masked
        km = _port(km, dev)
    return q, k, v, km


def _ext_errors(o, lse, ro, rlse):
    """max |dO|, max |dlse| over finite rows; and whether the -inf rows
    agree exactly (with O = 0 there)."""
    fin = torch.isfinite(rlse)
    same_inf = bool(torch.equal(torch.isfinite(lse), fin)
                    and (lse[~fin] == float("-inf")).all())
    dead = (~fin).permute(0, 2, 1)                      # [N, Tq, H]
    same_inf &= bool((o[dead] == 0).all())
    el = (lse[fin] - rlse[fin]).abs().max().item() if fin.any() else 0.0
    return (o.float() - ro.float()).abs().max().item(), el, same_inf


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol_o,tol_lse", [
    (torch.float32, 1e-4, 1e-4), (torch.bfloat16, 2e-2, 1e-3)])
@pytest.mark.parametrize("tq,tk,offset,d", [
    (128, 128, 0, 64), (192, 320, 0, 32), (192, 320, 320, 16),
    (320, 192, -100, 128), (256, 256, -256, 64), (100, 100, 37, 64),
    (64, 1000, 500, 64), (1000, 64, -900, 32),
    # the bf16 kernel's tiles: 64 or 128 q rows (one or two warpgroups),
    # 64 keys; Tq, Tk on either side of them, offsets that cut a 128-row
    # q tile mid-way (a warpgroup, or part of one, with no visible key)
    (1, 1, 0, 16), (1, 300, 300, 128), (63, 65, 0, 32), (65, 63, 63, 128),
    (127, 129, 0, 64), (129, 127, 127, 16), (300, 300, 0, 128),
    (300, 129, -64, 32), (129, 300, 300, 64), (300, 300, -64, 64),
    (300, 300, -100, 16), (256, 300, -200, 128), (300, 63, -37, 64)])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_flash_ext_kernel_matches_plain_on_card(tq, tk, offset, d, masked,
                                                dtype, tol_o, tol_lse):
    dev = _need_card()
    q, k, v, km = _ext_case(tq + tk + d, 2, tq, tk, 3, d, dev, dtype,
                            masked)
    before = port_flash.flash_attention_block.launches
    o, lse = port_flash.flash_attention_block(q, k, v, offset=offset,
                                              key_mask=km)
    torch.cuda.synchronize()
    assert port_flash.flash_attention_block.launches == before + 1
    ro, rlse = port_flash.flash_attention_block_plain(q, k, v, offset=offset,
                                                      key_mask=km)
    eo, el, same_inf = _ext_errors(o, lse, ro, rlse)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert eo <= tol_o and el <= tol_lse and same_inf


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("tq,tk", [(100, 170), (170, 100), (64, 129)])
def test_flash_ext_f32_at_every_offset_on_card(tq, tk, d):
    """K5 in f32 (3xTF32 on the tensor cores) at offsets from -Tq (no key
    visible) to Tk (every key), ragged Tq and Tk, with a key bias and a
    batch row whose every key is masked: O and lse within 1e-4 of the
    plain version, the rows with no visible key exactly O = 0 and lse =
    -inf."""
    dev = _need_card()
    q, k, v, km = _ext_case(tq * tk + d, 2, tq, tk, 3, d, dev,
                            torch.float32, True)
    offsets = sorted({-tq, -tq + 1, -tq // 2, -1, 0, 1, 63, 64, tk // 2,
                      tk - 1, tk})
    for offset in offsets:
        o, lse = port_flash.flash_attention_block(q, k, v, offset=offset,
                                                  key_mask=km)
        ro, rlse = port_flash.flash_attention_block_plain(
            q, k, v, offset=offset, key_mask=km)
        eo, el, same_inf = _ext_errors(o, lse, ro, rlse)
        assert eo <= 1e-4 and el <= 1e-4 and same_inf, offset


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol_o,tol_lse", [
    (torch.float32, 1e-4, 1e-4), (torch.bfloat16, 2e-2, 1e-3)])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_ext_length_mask_on_card(d, dtype, tol_o, tol_lse):
    """A length mask (the MHA layer's padding) masks whole key tiles,
    which the kernel does not multiply: lengths at and around the 64-key
    tile edges, one key and none, causal and full, against the plain
    version."""
    dev = _need_card()
    tk = 300
    lengths = [0, 1, 63, 64, 65, 128, 200, tk]
    q, k, v, _ = _ext_case(d, len(lengths), tk, tk, 2, d, dev, dtype,
                           False)
    km = _port((np.arange(tk)[None, :] < np.array(lengths)[:, None])
               .astype(np.float32), dev)
    for offset in (0, tk):
        o, lse = port_flash.flash_attention_block(q, k, v, offset=offset,
                                                  key_mask=km)
        ro, rlse = port_flash.flash_attention_block_plain(
            q, k, v, offset=offset, key_mask=km)
        eo, el, same_inf = _ext_errors(o, lse, ro, rlse)
        assert eo <= tol_o and el <= tol_lse and same_inf, offset


@pytest.mark.gpu
def test_flash_ext_reads_strided_heads_on_card():
    """q/k/v as [N, T, H, D] views of a wider projection (the MHA layer's
    reshape of x @ W) give the same result as contiguous copies."""
    dev = _need_card()
    rng = np.random.default_rng(1)
    x = _port(rng.standard_normal((2, 130, 3, 2 * 64)).astype(np.float32),
              dev)
    q, k = x[..., :64], x[..., 64:]
    assert not q.is_contiguous()
    a = port_flash.flash_attention_block(q, k, k, offset=0)
    b = port_flash.flash_attention_block(q.contiguous(), k.contiguous(),
                                         k.contiguous(), offset=0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_ext_reads_misaligned_bf16_views_on_card(d):
    """bf16 q/k/v views whose rows are not 16-byte aligned (the kernel
    copies them with plain loads instead of cp.async) give the same bits
    as contiguous copies, which it copies asynchronously."""
    dev = _need_card()
    rng = np.random.default_rng(d)
    x = _port(rng.standard_normal((2, 130, 3, 2 * d + 1)).astype(np.float32),
              dev, torch.bfloat16)
    q, k = x[..., 1:d + 1], x[..., d + 1:]
    assert q.stride(1) % 8 and k.storage_offset() % 8
    for offset in (0, 130, -40):
        a = port_flash.flash_attention_block(q, k, k, offset=offset)
        b = port_flash.flash_attention_block(q.contiguous(), k.contiguous(),
                                             k.contiguous(), offset=offset)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(1, 16), (65, 32), (192, 64), (300, 128),
                                 (1024, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_k4_and_k5_give_the_same_bits_on_card(t, d, causal, dtype):
    """K4 is K5's launch with no key bias and offset 0 (causal) or T
    (full): the same O and lse to the bit."""
    dev = _need_card()
    q, k, v = (_port(a, dev, dtype) for a in _qkv(t + d, 2, t, 3, d))
    o4, lse4 = port_flash.flash_attention(q, k, v, causal=causal)
    o5, lse5 = port_flash.flash_attention_block(q, k, v,
                                                offset=0 if causal else t)
    torch.cuda.synchronize()
    assert torch.equal(o4, o5) and torch.equal(lse4, lse5)


@pytest.mark.gpu
def test_flash_libraries_issue_tensor_core_instructions():
    """The built K4/K5 library holds wgmma (HGMMA in SASS, the bf16
    kernels), cp.async (LDGSTS, the K/V ring of both types) and TF32
    tensor-core products (HMMA ... TF32: the f32 kernels' 3xTF32 on
    mma.sync)."""
    _need_card()
    from deeplearning4j_tpu_torch.ops import build

    if build.cuobjdump_path() is None:
        pytest.skip("cuobjdump not found (it comes with the CUDA toolkit): "
                    "the SASS cannot be read on this machine")
    sass = build.sass("flash_attention")
    assert "HGMMA" in sass
    assert "LDGSTS" in sass
    assert any("HMMA" in line and "TF32" in line
               for line in sass.splitlines())


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_four_shard_ring_in_one_process_on_card(causal, masked):
    """Every (my, src) step a 4-rank ring takes, through K5, against the
    plain full attention."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
        ring_flash_finish,
        ring_flash_init,
        ring_flash_step,
    )

    p, tl = 4, 96
    q, k, v, km = _ext_case(7, 2, p * tl, p * tl, 4, 64, dev, torch.float32,
                            masked)
    shard = lambda a, r: a[:, r * tl:(r + 1) * tl]
    outs = []
    for my in range(p):
        st = ring_flash_init(shard(q, my))
        for step in range(p):
            src = (my - step) % p
            st = ring_flash_step(st, shard(q, my), shard(k, src),
                                 shard(v, src),
                                 None if km is None else shard(km, src),
                                 my=my, src=src, t_local=tl, n_dev=p,
                                 causal=causal)
        outs.append(ring_flash_finish(st, q.dtype))
    got = torch.cat(outs, dim=1)
    want = port_flash.flash_attention_block_plain(
        q, k, v, offset=0 if causal else p * tl, key_mask=km)[0]
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_flash_block_fn_gradients_match_autograd_through_plain_on_card():
    dev = _need_card()
    q, k, v, km = _ext_case(3, 2, 200, 300, 3, 64, dev, torch.float32, True)
    # autograd through the plain version's logsumexp gives NaN on a row
    # with every key masked (the blocked backward gives 0 there, as the
    # JAX package's does: tests/test_torch_flash_ext.py), so every row of
    # this case keeps some keys
    km[-1, ::3] = 1.0
    g = torch.randn((2, 200, 3, 64), device=dev)
    g_lse = torch.randn((2, 3, 200), device=dev)
    got, want = [], []
    for fn, out in ((lambda a, b, c: port_flash.FlashBlockFn.apply(
            a, b, c, km, 50), got), (lambda a, b, c:
            port_flash.flash_attention_block_plain(a, b, c, offset=50,
                                                   key_mask=km), want)):
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        o, lse = fn(*ins)
        fin = torch.isfinite(lse)
        torch.autograd.backward([o, torch.where(fin, lse, 0.0)],
                                [g, torch.where(fin, g_lse, 0.0)])
        out.extend(x.grad for x in ins)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-4


@pytest.mark.gpu
def test_flash_block_bwd_on_card_gives_zero_on_an_all_masked_row():
    """The blocked backward on CUDA tensors against the same call on the
    CPU, with a batch row whose every key is masked (so every query row of
    it sees no key): dq = dk = dv = 0 on that row, and agreement elsewhere
    within 1e-4 of the largest entry."""
    dev = _need_card()
    q, k, v, km = _ext_case(4, 2, 200, 300, 3, 64, "cpu", torch.float32,
                            True)
    assert (km[-1] == 0).all()
    o, lse = port_flash.flash_attention_block_plain(q, k, v, offset=50,
                                                    key_mask=km)
    assert (lse[-1] == float("-inf")).all()
    rng = np.random.default_rng(5)
    g = _port(rng.standard_normal((2, 200, 3, 64)).astype(np.float32))
    g_lse = _port(rng.standard_normal((2, 3, 200)).astype(np.float32))
    args = (q, k, v, km, 50, o, lse, g, g_lse)
    want = port_flash.flash_block_bwd(*args)
    got = port_flash.flash_block_bwd(
        *(a.to(dev) if torch.is_tensor(a) else a for a in args))
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        a = a.cpu()
        assert torch.isfinite(a).all()
        assert (a[-1] == 0).all() and (b[-1] == 0).all()
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-4


@pytest.mark.gpu
def test_flash_ext_refuses_what_the_kernel_does_not_take():
    dev = _need_card()
    q = torch.zeros((1, 8, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head size"):
        port_flash.flash_attention_block(q, q, q, offset=0)
    q = torch.zeros((1, 8, 2, 64), device=dev)
    with pytest.raises(ValueError, match="key_mask"):
        port_flash.flash_attention_block(
            q, q, q, offset=0, key_mask=torch.ones((1, 9), device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_attention_auto_on_card_raises_for_a_head_size_no_kernel_takes(
        masked):
    """No dense route on the card: a head size outside HEAD_DIMS raises
    in K4's or K5's wrapper, as the wrappers do themselves."""
    dev = _need_card()
    q = torch.zeros((1, 8, 2, 48), device=dev)
    km = torch.ones((1, 8), device=dev) if masked else None
    with pytest.raises(ValueError, match="head size"):
        port_flash.attention_auto(q, q, q, key_mask=km)


@pytest.mark.gpu
def test_masked_attention_network_on_the_card_goes_through_k5():
    """A MultiLayerNetwork of two MultiHeadAttention layers fitted on the
    card with a feature mask: K5 launches once per layer per fit, its
    plain version never; unmasked, K4 does."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(3).learning_rate(0.01)
            .updater("adam").list()
            .layer(0, L.MultiHeadAttention(n_in=16, n_out=64, num_heads=4,
                                           activation="tanh"))
            .layer(1, L.MultiHeadAttention(n_in=64, n_out=64, num_heads=2))
            .layer(2, L.RnnOutputLayer(n_in=64, n_out=5,
                                       activation="softmax",
                                       loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device=dev).init()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 70, 16)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (4, 70))]
    mask = (np.arange(70)[None] < np.array([[70], [40], [9], [1]])
            ).astype(np.float32)
    fns = (port_flash.flash_attention_block,
           port_flash.flash_attention_block_plain,
           port_flash.flash_attention, port_flash.flash_attention_plain)
    for fn in fns:
        fn.launches = 0
    losses = [float(net.fit(x, y, mask)) for _ in range(3)]
    assert [fn.launches for fn in fns] == [6, 0, 0, 0]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    net.fit(x, y)
    assert [fn.launches for fn in fns] == [6, 0, 2, 0]


# ---------------------------------------------------------------------------
# K7: the flash backward
# ---------------------------------------------------------------------------

TOL_BWD = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def _bwd_case(seed, n, tq, tk, h, d, offset, masked, with_glse, dev, dtype):
    """Inputs of K7 from K5's plain forward on the card: q, k, v, the key
    mask, o, lse, the cotangents g and g_lse (or None). ``masked``:
    False, True (each key kept with p = 0.8, the last batch row with every
    key masked) or "lengths" (a length mask, the first batch row 64 keys
    long, so that whole 64-key tiles are masked)."""
    q, k, v, km = _ext_case(seed, n, tq, tk, h, d, dev, dtype,
                            masked is True)
    if masked == "lengths":
        lengths = np.random.default_rng(seed + 2).integers(1, tk + 1, n)
        lengths[0] = min(64, tk)
        km = _port((np.arange(tk)[None] < lengths[:, None]).astype(
            np.float32), dev)
    o, lse = port_flash.flash_attention_block_plain(q, k, v, offset=offset,
                                                    key_mask=km)
    rng = np.random.default_rng(seed + 1)
    g = _port(rng.standard_normal((n, tq, h, d)).astype(np.float32), dev,
              dtype)
    g_lse = (_port(rng.standard_normal((n, h, tq)).astype(np.float32), dev)
             if with_glse else None)
    return q, k, v, km, offset, o, lse.float(), g, g_lse


def _rel_errors(got, want):
    return [((a.float() - b.float()).abs().max()
             / b.float().abs().max().clamp_min(1e-30)).item()
            for a, b in zip(got, want)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,tq,tk,h,d,offset,masked,with_glse", [
    (2, 130, 130, 3, 64, 0, False, False),     # causal, ragged T
    (1, 63, 63, 2, 16, 63, False, False),      # full
    (2, 96, 96, 2, 32, 0, False, False),
    (1, 192, 192, 2, 128, 0, False, False),
    (2, 200, 300, 3, 64, 50, True, True),      # K5: mask, offset, g_lse
    (2, 192, 320, 2, 64, -64, False, True),    # rows with no visible key
    (2, 256, 256, 2, 64, 256, True, False),    # the MHA fit's full + mask
    (1, 128, 128, 2, 64, -128, False, True),   # every key hidden
    (16, 1024, 1024, 32, 64, 0, False, False),  # the LM's training layer
    (3, 512, 512, 2, 64, 512, "lengths", False),  # whole key tiles masked
    (2, 300, 420, 3, 16, 60, True, True),      # ragged Tq != Tk, D = 16
    (2, 300, 420, 3, 128, 60, True, True),     # and D = 128
])
def test_flash_bwd_kernel_matches_plain_on_card(n, tq, tk, h, d, offset,
                                                masked, with_glse, dtype):
    dev = _need_card()
    args = _bwd_case(7, n, tq, tk, h, d, offset, masked, with_glse, dev,
                     dtype)
    before = (port_flash.flash_bwd.launches,
              port_flash.flash_block_bwd.launches)
    got = port_flash.flash_bwd(*args)
    torch.cuda.synchronize()
    assert (port_flash.flash_bwd.launches,
            port_flash.flash_block_bwd.launches) == (before[0] + 1,
                                                     before[1])
    want = port_flash.flash_block_bwd(*args)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.isfinite(a).all()
    if masked is True:  # the batch row with every key masked: no gradient
        for a in got:
            assert (a[-1] == 0).all()
    if masked:  # masked keys: dK and dV exactly 0
        for a in got[1:]:
            assert (a[args[3] == 0] == 0).all()
    if offset <= -tq:
        assert all((a == 0).all() for a in got)
    else:
        errs = _rel_errors(got, want)
        assert max(errs) <= TOL_BWD[dtype], errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_two_launches_give_the_same_bits_on_card(dtype):
    dev = _need_card()
    args = _bwd_case(9, 2, 300, 300, 4, 64, 0, True, True, dev, dtype)
    a = port_flash.flash_bwd(*args)
    b = port_flash.flash_bwd(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_flash_bwd_kernels_run_on_wgmma_and_cp_async():
    """K7's SASS, kernel by kernel: every bf16 kernel multiplies with wgmma
    (HGMMA), every f32 kernel with TF32 tensor-core products (HMMA ...
    TF32: 3xTF32 on mma.sync), and every kernel takes its tiles by
    cp.async (LDGSTS)."""
    _need_card()
    from deeplearning4j_tpu_torch.ops import build

    if build.cuobjdump_path() is None:
        pytest.skip("cuobjdump not found (it comes with the CUDA toolkit): "
                    "the SASS cannot be read on this machine")
    kernels = {name: text for name, text in
               build.sass_functions(build.sass("flash_bwd")).items()
               if "flash_bwd" in name}
    bf16 = [t for n, t in kernels.items() if "__nv_bfloat16" in n]
    f32 = [t for n, t in kernels.items() if "__nv_bfloat16" not in n]
    assert bf16 and f32
    for text in bf16:
        assert "HGMMA" in text and "LDGSTS" in text
    for text in f32:
        assert "LDGSTS" in text
        assert any("HMMA" in line and "TF32" in line
                   for line in text.splitlines())


@pytest.mark.gpu
def test_flash_fn_backward_goes_through_k7_on_card():
    """FlashFn and FlashBlockFn on CUDA tensors: the backward launches K7
    once and its plain version never; the gradients match autograd
    through K4's plain version within the bf16 bar."""
    dev = _need_card()
    q, k, v = (_port(a, dev, torch.bfloat16) for a in _qkv(3, 2, 256, 4, 64))
    g = torch.randn((2, 256, 4, 64), device=dev, dtype=torch.bfloat16)
    before = (port_flash.flash_bwd.launches,
              port_flash.flash_block_bwd.launches)
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    o = port_flash.FlashFn.apply(*ins, True)
    got = torch.autograd.grad(o, ins, g)
    assert (port_flash.flash_bwd.launches,
            port_flash.flash_block_bwd.launches) == (before[0] + 1,
                                                     before[1])
    ins = [x.clone().float().requires_grad_() for x in (q, k, v)]
    o, _ = port_flash.flash_attention_plain(*ins, causal=True)
    want = torch.autograd.grad(o, ins, g.float())
    assert max(_rel_errors(got, want)) <= TOL_BWD[torch.bfloat16]
    km = torch.ones((2, 256), device=dev)
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    o, _ = port_flash.FlashBlockFn.apply(*ins, km, 0)
    torch.autograd.grad(o, ins, g)
    assert port_flash.flash_bwd.launches == before[0] + 2
    assert port_flash.flash_block_bwd.launches == before[1]


@pytest.mark.gpu
def test_flash_bwd_refuses_what_the_kernel_does_not_take():
    dev = _need_card()
    q = torch.zeros((1, 8, 2, 48), device=dev)
    lse = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="head size"):
        port_flash.flash_bwd(q, q, q, None, 0, q, lse, q)
    q = torch.zeros((1, 8, 2, 64), device=dev)
    with pytest.raises(ValueError, match="lse"):
        port_flash.flash_bwd(q, q, q, None, 0, q, lse[:, :, :4], q)
    with pytest.raises(ValueError, match="key_mask"):
        port_flash.flash_bwd(q, q, q, torch.ones((1, 9), device=dev), 0, q,
                             torch.zeros((1, 2, 8), device=dev), q)


@pytest.mark.gpu
@pytest.mark.parametrize("policy,tol,tol_rest", [("performance", 1e-2, 2e-2),
                                                 ("strict", 1e-4, 1e-4)])
def test_transformer_step_on_card_reaches_wq_wk_wv_and_matches_cpu(
        policy, tol, tol_rest):
    """A TransformerLM step on the card: attention goes through FlashFn
    (K4 forward, K7 backward, once per layer each, no plain version), so
    Wq, Wk and Wv get nonzero gradients, and the loss and every gradient
    agree with the same step on the CPU, of each leaf's largest entry:
    the attention weights (Wq, Wk, Wv, Wo) within the dtype's bar (bf16
    1e-2, f32 1e-4). Under bf16 the other leaves' bar is 2e-2: each
    gradient comes back through bf16 tensors, whose roundings on the two
    devices differ, and ``pos``'s sums a few such rows. The gap is not
    K7's: ``scripts/lm_step_error.py`` runs this step on the card with
    the plain f32 backward in K7's place, and ``pos`` reads 1.06e-2 that
    way (1.13e-2 with K7; up to 1.58e-2 either way over 8 seeds, on an
    H100)."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.models import transformer as pt

    cfg = pt.TransformerConfig(vocab_size=128, d_model=128, n_layers=2,
                               n_heads=2, d_ff=256, max_len=128,
                               dtype_policy=policy, seed=4)
    params = pt.init_params(cfg, device="cpu")
    ids = np.random.default_rng(0).integers(0, 128, (4, 97))
    x, y = torch.from_numpy(ids[:, :-1]), torch.from_numpy(ids[:, 1:])
    counters = (port_flash.flash_attention, port_flash.flash_bwd,
                port_flash.flash_attention_plain, port_flash.flash_block_bwd)
    before = [fn.launches for fn in counters]
    on_card = pt.tree_map(lambda a: a.to(dev), params)
    loss, grads = pt.value_and_grad(
        lambda p: pt.loss_fn(p, x.to(dev), y.to(dev), cfg), on_card)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == \
        [cfg.n_layers, cfg.n_layers, 0, 0]
    want_loss, want = pt.value_and_grad(
        lambda p: pt.loss_fn(p, x, y, cfg), params)
    assert abs(float(loss) - float(want_loss)) <= tol * float(want_loss)
    for name in ("Wq", "Wk", "Wv"):
        assert grads["blocks"][name].abs().max().item() > 0, name
    errs = {}
    for (name, a), b in zip(pt._named(grads).items(),
                            pt.tree_leaves(want)):
        a = a.cpu()
        assert torch.isfinite(a).all(), name
        errs[name] = ((a - b).abs().max()
                      / b.abs().max().clamp_min(1e-30)).item()
    for name, err in errs.items():
        bar = tol if name in ("blocks.Wq", "blocks.Wk", "blocks.Wv",
                              "blocks.Wo") else tol_rest
        assert err <= bar, (name, errs)
    lm = pt.TransformerLM(cfg, device=dev, params=on_card)
    first = lm.fit(x, y)
    assert float(first) == pytest.approx(float(loss), rel=1e-6)
    assert lm.iteration == 1 and int(lm.opt["t"]) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("policy,k4_per_layer", [("dots", 1), ("block", 2)])
def test_transformer_remat_on_card_matches_no_remat(policy, k4_per_layer):
    """Remat on the card: the forward is bit-equal to no remat and the
    gradients within the bf16 bar (1e-2 of each leaf's largest entry);
    ``dots`` keeps K4's output (one launch per layer), ``block`` launches
    it again in the backward; K7 once per layer either way."""
    dev = _need_card()
    import dataclasses

    from deeplearning4j_tpu_torch.models import transformer as pt

    cfg = pt.TransformerConfig(vocab_size=128, d_model=128, n_layers=2,
                               n_heads=2, d_ff=256, max_len=128,
                               dtype_policy="performance", seed=5,
                               remat="none")
    params = pt.init_params(cfg, device=dev)
    ids = torch.from_numpy(
        np.random.default_rng(1).integers(0, 128, (4, 97))).to(dev)
    x, y = ids[:, :-1], ids[:, 1:]
    out = {}
    for name, c in (("none", cfg),
                    (policy, dataclasses.replace(cfg, remat=policy))):
        before = (port_flash.flash_attention.launches,
                  port_flash.flash_bwd.launches)
        with torch.enable_grad():
            live = pt.tree_map(lambda a: a.clone().requires_grad_(), params)
            logits, _ = pt.forward(live, x, c)
            grads = torch.autograd.grad(pt.nll_loss(logits, y),
                                        pt.tree_leaves(live))
        torch.cuda.synchronize()
        out[name] = (logits.detach(), grads,
                     port_flash.flash_attention.launches - before[0],
                     port_flash.flash_bwd.launches - before[1])
    assert torch.equal(out["none"][0], out[policy][0])
    for a, b in zip(out[policy][1], out["none"][1]):
        err = ((a.float() - b.float()).abs().max()
               / b.float().abs().max().clamp_min(1e-30)).item()
        assert err <= 1e-2
    assert out["none"][2:] == (cfg.n_layers, cfg.n_layers)
    assert out[policy][2:] == (k4_per_layer * cfg.n_layers, cfg.n_layers)


@pytest.mark.gpu
def test_bf16_loss_scaled_steps_on_card(monkeypatch):
    """DL4J_TPU_BF16 on the card: clean steps double the scale every
    growth interval; a step with an inf in an embedding row is skipped
    (scale halved, t and the params kept)."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.models import transformer as pt

    monkeypatch.setenv("DL4J_TPU_BF16", "1")
    monkeypatch.setenv("DL4J_TPU_LOSS_SCALE", "8:1")
    cfg = pt.TransformerConfig(vocab_size=128, d_model=128, n_layers=2,
                               n_heads=2, d_ff=256, max_len=128, seed=6)
    lm = pt.TransformerLM(cfg, device=dev)
    ids = np.random.default_rng(2).integers(0, 128, (4, 97))
    x, y = ids[:, :-1], ids[:, 1:]
    losses = [float(lm.fit(x, y)) for _ in range(2)]
    assert all(np.isfinite(losses))
    state = lambda: (float(lm.opt["loss_scale"]), int(lm.opt["ls_good"]),
                     int(lm.opt["ls_skipped"]), int(lm.opt["t"]))
    assert state() == (32.0, 0, 0, 2)
    embed = lm.params["embed"].clone()
    embed[5, 0] = float("inf")
    lm.params = dict(lm.params, embed=embed)
    wq = lm.params["blocks"]["Wq"].clone()
    lm.fit(x, y)
    assert state() == (16.0, 0, 1, 2)
    assert torch.equal(lm.params["blocks"]["Wq"], wq)


def _leaf_errors(got, want):
    """Each leaf's largest error, of its largest entry in ``want`` (the
    CPU result)."""
    from deeplearning4j_tpu_torch.models import transformer as pt

    return {name: ((a.cpu() - b).abs().max()
                   / b.abs().max().clamp_min(1e-30)).item()
            for (name, a), b in zip(pt._named(got).items(),
                                    pt.tree_leaves(want))}


@pytest.mark.gpu
@pytest.mark.parametrize("strategy,fwd", [("ring", "flash_attention_block"),
                                          ("ulysses", "flash_attention")])
def test_sequence_parallel_step_on_a_world1_nccl_group_matches_cpu(
        strategy, fwd, tmp_path):
    """The ring step (K5 forward, K7 backward with the lse cotangent) and
    the Ulysses step (K4, K7) on a world-1 NCCL group, strict f32: the
    loss and every gradient leaf within 1e-4 (of each leaf's largest
    entry) of the dense step on the CPU, once per layer each, no plain
    version; the step returns the same loss and moves Wq."""
    dev = _need_card()
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.parallel.mesh import init_seq_group

    cfg = pt.TransformerConfig(vocab_size=128, d_model=128, n_layers=2,
                               n_heads=2, d_ff=256, max_len=128, seed=7)
    params = pt.init_params(cfg, device="cpu")
    ids = np.random.default_rng(3).integers(0, 128, (2, 129))
    x, y = torch.from_numpy(ids[:, :-1]), torch.from_numpy(ids[:, 1:])
    counters = {fn.__name__: fn for fn in (
        port_flash.flash_attention, port_flash.flash_attention_block,
        port_flash.flash_bwd, port_flash.flash_attention_plain,
        port_flash.flash_attention_block_plain, port_flash.flash_block_bwd)}
    group = init_seq_group(str(tmp_path / "store"), 0, 1, backend="nccl")
    try:
        on_card = pt.tree_map(lambda a: a.to(dev), params)
        xd, yd = x.to(dev), y.to(dev)
        before = {k: fn.launches for k, fn in counters.items()}
        loss, grads = pt.value_and_grad(lambda p: pt.nll_loss(
            pt.ring_forward(p, xd, cfg, group, strategy), yd), on_card)
        torch.cuda.synchronize()
        ran = {k: fn.launches - before[k] for k, fn in counters.items()}
        step = pt.make_ring_train_step(cfg, group, strategy=strategy)
        new, opt, step_loss = step(on_card, pt.init_opt_state(on_card),
                                   xd, yd)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert ran == {k: (cfg.n_layers if k in (fwd, "flash_bwd") else 0)
                   for k in counters}
    want_loss, want = pt.value_and_grad(
        lambda p: pt.loss_fn(p, x, y, cfg), params)
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * float(want_loss)
    assert float(step_loss) == pytest.approx(float(loss), rel=1e-6)
    for name in ("Wq", "Wk", "Wv"):
        assert grads["blocks"][name].abs().max().item() > 0, name
    errs = _leaf_errors(grads, want)
    assert max(errs.values()) <= 1e-4, errs
    assert int(opt["t"]) == 1
    assert not torch.equal(new["blocks"]["Wq"], on_card["blocks"]["Wq"])


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True], ids=["causal", "masked"])
def test_four_shard_ring_backward_through_k5_k7_on_card(monkeypatch,
                                                        masked):
    """The 4-shard ring driven in one process with autograd (K5 forward
    per (my, src) step, K7 backward with the lse cotangent of the
    log-space combination), bf16 causal: dq, dk, dv within 1e-2 of each
    gradient's largest entry of the same chain through K5's and K7's
    plain versions on the card; masked keys' dK and dV exactly 0."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.parallel import sequence_parallel as psp

    p, n, t, h, d = 4, 2, 512, 4, 64
    rng = np.random.default_rng(11)
    q, k, v, g = (_port(rng.standard_normal((n, t, h, d)), dev,
                        torch.bfloat16) for _ in range(4))
    km = None
    if masked:
        km = _port((rng.random((n, t)) < 0.8).astype(np.float32), dev)
        km[:, 0] = 1.0

    def chain():
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        tl = t // p
        sh = lambda a, r: None if a is None else a[:, r * tl:(r + 1) * tl]
        outs = []
        for my in range(p):
            st = psp.ring_flash_init(sh(leaves[0], my))
            for step in range(p):
                src = (my - step) % p
                st = psp.ring_flash_step(st, sh(leaves[0], my),
                                         sh(leaves[1], src),
                                         sh(leaves[2], src), sh(km, src),
                                         my=my, src=src, t_local=tl,
                                         n_dev=p, causal=True)
            outs.append(psp.ring_flash_finish(st, q.dtype))
        return torch.autograd.grad(torch.cat(outs, 1), leaves, g)

    before = (port_flash.flash_attention_block.launches,
              port_flash.flash_bwd.launches)
    got = chain()
    torch.cuda.synchronize()
    assert (port_flash.flash_attention_block.launches - before[0],
            port_flash.flash_bwd.launches - before[1]) == (p * p, p * p)
    monkeypatch.setattr(port_flash, "flash_attention_block",
                        port_flash.flash_attention_block_plain)
    monkeypatch.setattr(port_flash, "flash_bwd", port_flash.flash_block_bwd)
    want = chain()
    errs = _rel_errors(got, want)
    assert max(errs) <= TOL_BWD[torch.bfloat16], errs
    if masked:
        hidden = km == 0
        assert (got[1][hidden] == 0).all() and (got[2][hidden] == 0).all()


def _bert_case(dev):
    from deeplearning4j_tpu_torch.models import bert as pb

    cfg = pb.BertConfig(vocab_size=128, d_model=128, n_layers=2, n_heads=2,
                        d_ff=256, max_len=64, mask_token_id=127, seed=9)
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 127, (4, 64))
    ids[0, 40:] = 0
    ids[2] = 0  # an all-pad row: the mean of V, as the JAX package
    return cfg, pb.init_params(cfg, device="cpu"), ids


@pytest.mark.gpu
def test_bert_mlm_step_on_card_matches_cpu():
    """One BERT MLM step on the card, strict f32: K5 at offset T with the
    key mask forward and K7 backward, once per layer each, no plain
    version; the loss within 1e-4 relative and every gradient within 1e-4
    of each leaf's largest entry of the CPU's; ``BertMLM.fit`` on the card
    gives the same loss."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.models import bert as pb

    cfg, params, ids = _bert_case(dev)
    x, y, w = (torch.from_numpy(a) for a in pb.mask_tokens(
        ids, cfg, np.random.default_rng(cfg.seed)))
    counters = (port_flash.flash_attention_block, port_flash.flash_bwd,
                port_flash.flash_attention_block_plain,
                port_flash.flash_block_bwd)
    before = [fn.launches for fn in counters]
    on_card = tree_map(lambda a: a.to(dev), params)
    loss, grads = pb.value_and_grad(lambda p: pb.mlm_loss(
        p, x.to(dev), y.to(dev), w.to(dev), cfg), on_card)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == \
        [cfg.n_layers, cfg.n_layers, 0, 0]
    want_loss, want = pb.value_and_grad(
        lambda p: pb.mlm_loss(p, x, y, w, cfg), params)
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * float(want_loss)
    for name in ("Wq", "Wk", "Wv"):
        assert grads["blocks"][name].abs().max().item() > 0, name
    errs = _leaf_errors(grads, want)
    assert max(errs.values()) <= 1e-4, errs
    with torch.inference_mode():
        emb = pb.encode(on_card, torch.from_numpy(ids).to(dev), cfg).cpu()
        want_emb = pb.encode(params, torch.from_numpy(ids), cfg)
    assert (emb - want_emb).abs().max().item() <= 1e-4
    mlm = pb.BertMLM(cfg, device=dev, params=on_card)
    assert mlm.fit(ids) == pytest.approx(float(loss), rel=1e-6)


@pytest.mark.gpu
def test_bert_classifier_step_on_card_matches_cpu():
    """One fine-tune step on the card, strict f32: the pooled classifier's
    loss within 1e-4 relative and every gradient within 1e-4 of each
    leaf's largest entry of the CPU's; ``BertClassifier.fit`` on the card
    gives the same loss and, at ``encoder_lr_scale=0``, leaves the
    encoder bit-equal."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.models import bert as pb

    cfg, params, ids = _bert_case(dev)
    labels = torch.tensor([0, 1, 1, 0])
    head = pb.init_classifier_head(cfg, 2, seed=1, device="cpu")
    both = {"encoder": params, "head": head}

    def loss_of(b, tokens, lab):
        logits = pb.classify_logits(b["encoder"], b["head"], tokens, cfg)
        return torch.nn.functional.cross_entropy(logits, lab)

    on_card = tree_map(lambda a: a.to(dev), both)
    tok = torch.from_numpy(ids)
    loss, grads = pb.value_and_grad(
        lambda b: loss_of(b, tok.to(dev), labels.to(dev)), on_card)
    want_loss, want = pb.value_and_grad(
        lambda b: loss_of(b, tok, labels), both)
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * float(want_loss)
    errs = _leaf_errors(grads, want)
    assert max(errs.values()) <= 1e-4, errs
    mlm = pb.BertMLM(cfg, device=dev,
                     params=tree_map(lambda a: a.to(dev), params))
    clf = pb.BertClassifier(mlm, 2, encoder_lr_scale=0.0)
    clf.state = {"encoder": clf.state["encoder"],
                 "head": tree_map(lambda a: a.to(dev), head)}
    assert clf.fit(ids, labels.numpy()) == pytest.approx(float(loss),
                                                         rel=1e-6)
    for a, b in zip(tree_leaves(clf.state["encoder"]),
                    tree_leaves(mlm.params)):
        assert torch.equal(a, b)


# -- the int8 /predict path and unload (the serving planes) ----------------


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 200, 80), (100, 200, 80),
                                   (6400, 200, 80), (1, 256, 512),
                                   (256, 256, 512), (256, 512, 512),
                                   (1, 512, 10), (256, 512, 10),
                                   (17, 10, 10), (16, 16, 16)])
def test_int8_matmul_on_card_is_bit_equal_to_the_cpu(m, k, n):
    """``int8_matmul`` on the card (torch._int_mm on operands zero-padded
    to its shape rules) gives the exact int32 product of the CPU path at
    the char-RNN head's and the lowprec MLP's shapes, M = 1 and N = 10
    included, and counts one launch."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.ops import lowprec

    rng = np.random.default_rng(m + k + n)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    before = (lowprec.int8_matmul.launches,
              lowprec.int8_matmul_plain.launches)
    got = lowprec.int8_matmul(xq.to(dev), wq.to(dev))
    assert lowprec.int8_matmul.launches == before[0] + 1
    assert lowprec.int8_matmul_plain.launches == before[1]
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), lowprec.int8_matmul_plain(xq, wq))


def _int8_inputs(qnet, x):
    """The inputs of every int8_dense call of one QuantizedNet forward,
    and its output (host arrays)."""
    from deeplearning4j_tpu_torch.ops import lowprec

    seen, orig = [], lowprec.int8_dense

    def rec(xx, *a, **kw):
        seen.append(xx.detach().float().cpu().numpy())
        return orig(xx, *a, **kw)

    lowprec.int8_dense = rec
    try:
        out = qnet.output(x).float().cpu().numpy()
    finally:
        lowprec.int8_dense = orig
    return seen, out


@pytest.mark.gpu
def test_quantized_char_rnn_on_card_matches_cpu_per_code():
    """A quantized char-RNN (vocab 80, 2 GravesLSTM x 200, the RnnOutput
    head int8) on the card against the same net on the CPU: the head's
    input codes agree except for one-step tie flips in at most 1e-4 of
    the entries, the outputs within 1e-5 plus the sum of |dcode| *
    x_scale * w_scale * |w_q| over the flips; K1 ran (no plain scan) and
    the product went through torch._int_mm."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.etl.calibrate import QuantCalibrator
    from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_conf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import lowprec

    conf = char_rnn_conf(80, lstm_size=200, num_layers=2, seed=4)
    cpu = MultiLayerNetwork(conf, device="cpu").init(input_shape=(1, 80))
    card = MultiLayerNetwork(conf, device=dev).init(input_shape=(1, 80))
    card.params = tree_map(lambda a: a.to(dev), cpu.params)
    card.states = tree_map(lambda a: a.to(dev), cpu.states)
    rng = np.random.default_rng(5)
    eye = np.eye(80, dtype=np.float32)
    calib = [eye[rng.integers(0, 80, (16, 50))] for _ in range(2)]
    spec = QuantCalibrator().fit(cpu, calib).spec(cpu)
    qcpu, qcard = (lowprec.QuantizedNet(n, spec) for n in (cpu, card))
    x = eye[rng.integers(0, 80, (24, 50))]
    k1 = (port_lstm.lstm_scan.launches, port_lstm.lstm_scan_plain.launches,
          lowprec.int8_matmul.launches)
    (xg,), got = _int8_inputs(qcard, x)
    assert (port_lstm.lstm_scan.launches - k1[0],
            port_lstm.lstm_scan_plain.launches - k1[1],
            lowprec.int8_matmul.launches - k1[2]) == (2, 0, 1)
    (xw,), want = _int8_inputs(qcpu, x)
    q = qcpu.params["quant"][2]
    xs = q["x_scale"]
    cg = lowprec.int8_quantize_rows(torch.from_numpy(xg), xs).numpy()
    cw = lowprec.int8_quantize_rows(torch.from_numpy(xw), xs).numpy()
    d = np.abs(cg.astype(np.int64) - cw)
    assert d.max() <= 1 and (d > 0).sum() <= max(1, 1e-4 * d.size), \
        int((d > 0).sum())
    per_k = (q["w_scale"].numpy()[None, :]
             * np.abs(q["wq"].numpy().astype(np.float64))).max(1)
    bar = 1e-5 + (d * float(xs) * per_k).sum(1).reshape(got.shape[:-1])
    assert (np.abs(got - want).max(-1) <= bar).all()


@pytest.mark.gpu
def test_unload_frees_the_records_device_memory():
    """Retiring a record on the card stops its batcher and drops its
    tensors: torch.cuda.memory_allocated falls by at least the record's
    hbm_report param_bytes."""
    import gc

    dev = _need_card()
    from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_conf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine

    net = MultiLayerNetwork(char_rnn_conf(80, lstm_size=512, num_layers=2,
                                          seed=1), device=dev).init(
        input_shape=(1, 80))
    eng = ServingEngine(model=net, input_shape=(20, 80), device=dev)
    del net
    try:
        x = np.eye(80, dtype=np.float32)[np.zeros((3, 20), np.int64)]
        eng.predict(x)
        param_bytes = eng.hbm_report()["models"]["default"]["param_bytes"]
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        eng.retire("default")
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        assert param_bytes > 4 * 2**20
        assert before - after >= param_bytes, (before, after, param_bytes)
    finally:
        eng.stop()


def _card_and_cpu_twins(build, dev, **kw):
    """The same network on the card and on the CPU (the card's weights
    copied over)."""
    net = build(device=dev, **kw)
    cpu = build(device="cpu", **kw)
    cpu.params = tree_map(lambda a: a.cpu(), net.params)
    cpu.states = tree_map(lambda a: a.cpu(), net.states)
    return net, cpu


@pytest.mark.gpu
@pytest.mark.parametrize("which,n", [("lenet5", 64), ("alexnet", 2)])
def test_cnn_output_on_card_matches_cpu(which, n):
    """LeNet-5 (28x28) and AlexNet (227x227) ``output`` on the card
    (cuDNN, TF32 off) against the same weights on the CPU, within 1e-4 of
    the largest probability."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.models.alexnet import build_alexnet
    from deeplearning4j_tpu_torch.models.lenet import build_lenet5

    build = build_lenet5 if which == "lenet5" else build_alexnet
    net, cpu = _card_and_cpu_twins(build, dev)
    size = net._input_shape
    x = np.random.default_rng(0).random((n,) + tuple(size)).astype(
        np.float32)
    got = net.output(x).cpu()
    want = cpu.output(x)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.gpu
def test_cnn_path_runs_cudnn_without_tf32():
    """After an entry point on the card, cuDNN and cuBLAS may not use
    TF32, and a LeNet-5-sized convolution with a 3x3x256 reduction agrees
    with f64 within 1e-5 of its largest entry (TF32's 10-bit mantissa
    would leave ~1e-3)."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.models.lenet import build_lenet5

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    net = build_lenet5(device=dev)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    from deeplearning4j_tpu_torch.nn.conf import ConvolutionLayer
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        ConvolutionLayerImpl,
    )

    layer = ConvolutionLayerImpl(ConvolutionLayer(
        n_in=256, n_out=64, kernel_size=(3, 3), activation="identity"))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 12, 12, 256)).astype(np.float32)
    w = rng.normal(size=(3, 3, 256, 64)).astype(np.float32)
    b = np.zeros(64, np.float32)
    got = layer.preout({"W": _port(w, dev), "b": _port(b, dev)},
                       _port(x, dev)).cpu().double()
    want = layer.preout({"W": _port(w, "cpu", torch.float64),
                         "b": _port(b, "cpu", torch.float64)},
                        _port(x, "cpu", torch.float64))
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err < 1e-5, err
    assert net.fit(np.zeros((4, 28, 28, 1), np.float32),
                   np.eye(10, dtype=np.float32)[:4]).device.type == "cuda"


def embedding_lstm_net(dev, vocab=80, width=200, t=100, seed=5):
    """EmbeddingLayer(vocab -> width) -> GravesLSTM(width, tanh) ->
    RnnOutputLayer(vocab), the char-RNN's widths."""
    from deeplearning4j_tpu_torch.nn import conf as pconf
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
        ReshapePreProcessor,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (pconf.NeuralNetConfiguration.builder().seed(seed)
            .learning_rate(0.01).updater("rmsprop").list()
            .layer(0, pconf.EmbeddingLayer(n_in=vocab, n_out=width,
                                           activation="identity"))
            .layer(1, pconf.GravesLSTM(n_in=width, n_out=width,
                                       activation="tanh"))
            .layer(2, pconf.RnnOutputLayer(n_in=width, n_out=vocab,
                                           activation="softmax",
                                           loss_function="mcxent"))
            .input_preprocessor(1, ReshapePreProcessor((t, width)))
            .build())
    return MultiLayerNetwork(conf, device=dev).init(input_shape=(t,))


@pytest.mark.gpu
def test_embedding_lstm_fit_on_card_goes_through_k1_and_k2():
    """The Embedding -> LSTM net's fit on the card launches K1 and K2 once
    each and never their plain versions; its first step agrees with the
    same step on the CPU within 1e-4 of each param's largest entry."""
    dev = _need_card()
    net = embedding_lstm_net(dev, t=20)
    cpu = embedding_lstm_net("cpu", t=20)
    cpu.params = tree_map(lambda a: a.cpu(), net.params)
    cpu.updater_state = cpu.updater.init(cpu.params)
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 80, (8, 20))
    y = np.eye(80, dtype=np.float32)[rng.integers(0, 80, (8, 20))]
    counters = (port_lstm.lstm_scan, port_lstm.lstm_scan_bwd,
                port_lstm.lstm_scan_plain, port_lstm.lstm_scan_bwd_plain)
    for c in counters:
        c.launches = 0
    loss = net.fit(idx, y)
    assert [c.launches for c in counters] == [1, 1, 0, 0]
    want = cpu.fit(idx, y)
    assert abs(float(loss) - float(want)) < 1e-4 * abs(float(want))
    for got, ref in zip(tree_leaves(net.params), tree_leaves(cpu.params)):
        assert (got.cpu() - ref).abs().max().item() \
            <= 1e-4 * ref.abs().max().item()


def seq2seq_graph(dev, vocab=80, hidden=200, seed=6, tbptt=None):
    """The encoder-decoder ComputationGraph: GravesLSTM encoder ->
    LastTimeStepVertex -> DuplicateToTimeSeriesVertex against the decoder
    input -> MergeVertex with it -> GravesLSTM decoder ->
    RnnOutputLayer(vocab)."""
    from deeplearning4j_tpu_torch.nn import conf as pconf
    from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    gb = (pconf.NeuralNetConfiguration.builder().seed(seed)
          .learning_rate(0.003).updater("rmsprop").graph_builder()
          .add_inputs("enc_in", "dec_in")
          .add_layer("enc", pconf.GravesLSTM(n_in=vocab, n_out=hidden,
                                             activation="tanh"), "enc_in")
          .add_vertex("last", pgraph.LastTimeStepVertex(), "enc")
          .add_vertex("dup", pgraph.DuplicateToTimeSeriesVertex(
              reference_input="dec_in"), "last")
          .add_vertex("merge", pgraph.MergeVertex(), "dup", "dec_in")
          .add_layer("dec", pconf.GravesLSTM(n_in=hidden + vocab,
                                             n_out=hidden,
                                             activation="tanh"), "merge")
          .add_layer("out", pconf.RnnOutputLayer(
              n_in=hidden, n_out=vocab, activation="softmax",
              loss_function="mcxent"), "dec")
          .set_outputs("out"))
    if tbptt:
        gb = (gb.backprop_type("truncated_bptt").t_bptt_forward_length(tbptt)
              .t_bptt_backward_length(tbptt))
    return ComputationGraph(gb.build(), device=dev).init(
        {"enc_in": (-1, vocab), "dec_in": (-1, vocab)})


def _graph_cpu_twin(net, build):
    cpu = build("cpu")
    cpu.params = tree_map(lambda a: a.to("cpu", copy=True), net.params)
    cpu.states = tree_map(lambda a: a.to("cpu", copy=True), net.states)
    cpu.updater_state = cpu.updater.init(cpu.params)
    return cpu


def _assert_vertices_close(net, cpu, rel=1e-4):
    """Every layer vertex's params and states within ``rel`` of that
    vertex's largest entry on the CPU (a bias ahead of BN gets only
    rounding noise, so a leaf's own largest entry is no bar)."""
    for name in net.params:
        for tree_c, tree_p in ((net.params, cpu.params),
                               (net.states, cpu.states)):
            ref = tree_leaves(tree_p[name])
            if not ref:
                continue
            top = max(r.abs().max().item() for r in ref if r.numel())
            for got, want in zip(tree_leaves(tree_c[name]), ref):
                if want.numel():
                    err = (got.cpu() - want).abs().max().item()
                    assert err <= rel * top, (name, err, top)


@pytest.mark.gpu
def test_seq2seq_graph_fit_on_card_goes_through_k1_and_k2():
    """The seq2seq graph's fit on the card launches K1 and K2 once per
    LSTM vertex (twice each per fit) and never their plain versions; the
    first step agrees with the CPU's within 1e-4 of each vertex's largest
    entry; a TBPTT fit carries h0/c0 through K1; ``rnn_time_step`` over
    the whole sequence gives ``output``'s last step within 1e-4."""
    dev = _need_card()
    build = lambda d: seq2seq_graph(d, vocab=20, hidden=64)
    net = build(dev)
    cpu = _graph_cpu_twin(net, build)
    rng = np.random.default_rng(3)
    eye = np.eye(20, dtype=np.float32)
    enc, dec, y = (eye[rng.integers(0, 20, (8, 24))] for _ in range(3))
    counters = (port_lstm.lstm_scan, port_lstm.lstm_scan_bwd,
                port_lstm.lstm_scan_plain, port_lstm.lstm_scan_bwd_plain)
    for c in counters:
        c.launches = 0
    loss = net.fit([enc, dec], [y])
    assert [c.launches for c in counters] == [2, 2, 0, 0]
    want = cpu.fit([enc, dec], [y])
    assert abs(float(loss) - float(want)) < 1e-4 * abs(float(want))
    _assert_vertices_close(net, cpu)
    (full,) = net.output(enc, dec)
    net.rnn_clear_previous_state()
    (last,) = net.rnn_time_step(enc, dec)
    assert (last - full[:, -1]).abs().max().item() < 1e-4
    tb = seq2seq_graph(dev, vocab=20, hidden=64, tbptt=12)
    tb.params = tree_map(torch.clone, net.params)
    for c in counters:
        c.launches = 0
    assert np.isfinite(float(tb.fit([enc, dec], [y])))
    assert [c.launches for c in counters] == [4, 4, 0, 0]  # 2 windows


@pytest.mark.gpu
def test_resnet50_first_step_on_card_matches_cpu():
    """ResNet-50 at 224 x 224, 1000 classes, batch 2, strict f32 (cuDNN,
    TF32 off): the first step's loss within 1e-4 relative of the CPU's,
    BN's state within 1e-4 of each vertex's largest entry, and the params
    against the same step in f64 on the CPU: the card's worst vertex
    (its error over its largest entry) within four times the CPU's own
    worst f32 vertex (two f32 summation orders, each as far off):
    f32 gradients through 53 BN layers of an untrained ResNet at batch 2
    lose whole digits, on any device."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.models.resnet import build_resnet50

    net = build_resnet50(device=dev)
    build = lambda d: build_resnet50(device=d)
    cpu = _graph_cpu_twin(net, build)
    cpu64 = _graph_cpu_twin(net, build)
    cpu64.params = tree_map(torch.Tensor.double, cpu64.params)
    cpu64.states = tree_map(torch.Tensor.double, cpu64.states)
    cpu64.updater_state = cpu64.updater.init(cpu64.params)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, 2)]
    loss = net.fit(x, y)
    want = cpu.fit(x, y)
    cpu64.fit(x.astype(np.float64), y.astype(np.float64))
    assert abs(float(loss) - float(want)) < 1e-4 * abs(float(want))

    def rel(got, ref):
        ref = [r.double() for r in tree_leaves(ref) if r.numel()]
        got = [g.cpu().double() for g in tree_leaves(got) if g.numel()]
        if not ref:
            return 0.0
        top = max(r.abs().max().item() for r in ref)
        return max((g - r).abs().max().item() for g, r in zip(got, ref)) / top

    card = {n: rel(net.params[n], cpu64.params[n]) for n in net.params}
    own = {n: rel(cpu.params[n], cpu64.params[n]) for n in net.params}
    assert max(card.values()) <= 4 * max(own.values()) + 1e-4, (
        max(card.items(), key=lambda kv: kv[1]), max(own.values()))
    for name in net.states:
        assert rel(net.states[name], cpu.states[name]) <= 1e-4, name


def _search_corpus(seed, n, dim, clusters, spread=0.05):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, dim)).astype(np.float32)
    pts = centers[rng.integers(0, clusters, n)] + spread * rng.normal(
        size=(n, dim))
    return pts.astype(np.float32), rng


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact", "ivf"])
def test_vector_store_on_card_matches_cpu(kind):
    """/search's store on the card against the same store on the CPU:
    the packed arena and ids equal, the IVF member table and centroids
    of the same k-means (the same draws; centers within 1e-4), scores
    within 1e-4 (TF32 off), ids equal where the CPU's k-th and (k+1)-th
    scores are 1e-4 apart."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.retrieval import VectorStore

    vecs, rng = _search_corpus(60, 4096, 64, 32)
    kw = dict(capacity=8192, kind=kind, clusters=32, nprobe=4)
    card = VectorStore(64, device=dev, **kw)
    cpu = VectorStore(64, device="cpu", **kw)
    for s in (card, cpu):
        s.upsert(np.arange(4096), vecs)
        s.delete(np.arange(0, 4096, 5))
        s.publish()
    assert torch.equal(card.snapshot.vecs.cpu(), cpu.snapshot.vecs)
    np.testing.assert_array_equal(card.snapshot.ids, cpu.snapshot.ids)
    if kind == "ivf":
        assert torch.allclose(card.snapshot.centroids.cpu(),
                              cpu.snapshot.centroids, atol=1e-4)
        agree = (card.snapshot.members.cpu() == cpu.snapshot.members)
        assert agree.float().mean() > 0.99
    q = vecs[rng.integers(0, 4096, 64)] + 0.01 * rng.normal(size=(64, 64))
    ids, scores = card.search(q, k=10)
    ref_ids, ref_scores = cpu.search(q, k=11)
    if kind == "ivf":  # the same tables: compare on the CPU's snapshot
        ref_ids, ref_scores = cpu._ivf.search(
            card.snapshot.__class__(
                vecs=cpu.snapshot.vecs, ids=cpu.snapshot.ids,
                n=cpu.snapshot.n, generation=1,
                centroids=card.snapshot.centroids.cpu(),
                members=card.snapshot.members.cpu()), q, k=11)
    np.testing.assert_allclose(scores, ref_scores[:, :10], atol=1e-4)
    for r in range(64):
        if ref_scores[r, 9] - ref_scores[r, 10] >= 1e-4:
            assert set(ids[r]) == set(ref_ids[r, :10]), r
    assert card.probe_recall(q) >= 0.9


@pytest.mark.gpu
def test_kmeans_on_card_matches_cpu():
    """The same k-means on the card and the CPU: the same k-means++ rows
    (the draws read D^2 on the host), iterations equal, centers within
    1e-4 and at least 99.9 % of assignments equal (f32 sums in another
    order)."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.clustering import KMeansClustering

    x, _ = _search_corpus(61, 20000, 96, 40, spread=0.2)
    card = KMeansClustering(40, max_iterations=25, seed=3, device=dev).fit(x)
    cpu = KMeansClustering(40, max_iterations=25, seed=3,
                           device="cpu").fit(x)
    assert card.seed_rows == cpu.seed_rows
    assert card.iterations_run == cpu.iterations_run
    np.testing.assert_allclose(card.centers_, cpu.centers_, atol=1e-4)
    assert (card.assignments_ == cpu.assignments_).mean() >= 0.999
    assert card.device_assignments.device.type == "cuda"


@pytest.mark.gpu
def test_publish_during_searches_on_card():
    """Searches on the card from three threads while five publishes swap
    the generation: none fails, every answer's ids lie in one published
    generation's live set."""
    import threading

    dev = _need_card()
    from deeplearning4j_tpu_torch.retrieval import VectorStore

    vecs, rng = _search_corpus(62, 9000, 32, 16)
    store = VectorStore(32, capacity=10000, kind="ivf", clusters=16,
                        nprobe=4, device=dev)
    store.upsert(np.arange(4000), vecs[:4000])
    store.publish()
    live = {1: set(range(4000))}
    q = vecs[rng.integers(0, 4000, 8)]
    stop, errs, answers = threading.Event(), [], []

    def searcher():
        while not stop.is_set():
            try:
                answers.append(store.search(q, k=5)[0])
            except Exception as e:  # noqa: BLE001 — the contract
                errs.append(e)
                return

    threads = [threading.Thread(target=searcher) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for g in range(5):
            lo = 4000 + 1000 * g
            store.upsert(np.arange(lo, lo + 1000), vecs[lo:lo + 1000])
            store.delete(np.arange(g * 500, g * 500 + 500))
            store.publish()
            live[g + 2] = set(int(i) for i in store.snapshot.ids
                              if i >= 0)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert errs == [] and answers and store.generation == 6
    for ids in answers:
        got = set(int(i) for i in ids.ravel() if i >= 0)
        assert any(got <= s for s in live.values())


# ------------------------------------------------------- the training runtime

@pytest.mark.gpu
def test_staged_batches_equal_the_host_batches_under_a_long_kernel():
    """The stager's copies run on its side stream while a sleep kernel
    holds the consumer's stream; the consumer waits on each batch's event.
    The caller's pinned host batch is overwritten right after ``put``
    (the stager copied it into its own pinned buffer first); 50 rounds."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.datasets.iterator import DataSet
    from deeplearning4j_tpu_torch.etl.pipeline import Stager

    stager = Stager(dev)
    rng = np.random.default_rng(0)
    for k in range(50):
        f = torch.from_numpy(rng.standard_normal((256, 1024)).astype(
            np.float32)).pin_memory()
        y = torch.from_numpy(rng.integers(0, 9, (256,))).pin_memory()
        want_f, want_y = f.clone(), y.clone()
        torch.cuda._sleep(2_000_000)  # ~1 ms on the consumer's stream
        staged = stager.put(DataSet(f, y))
        f.fill_(-1.0)
        y.fill_(-1)
        ds = stager.take(staged)
        got_f = ds.features * 1.0  # consumer-stream work on the batch
        assert ds.features.device.type == "cuda"
        assert torch.equal(got_f.cpu(), want_f), k
        assert torch.equal(ds.labels.cpu(), want_y), k
    stager.drain()
    assert stager.batches == 50 and not stager._inflight


@pytest.mark.gpu
def test_the_native_feed_on_the_card_equals_the_plain_one():
    dev = _need_card()
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.etl.pipeline import InputPipeline

    rng = np.random.default_rng(1)
    x = rng.standard_normal((1000, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 1000)]
    pipe = InputPipeline.from_native(x, y, 128, epochs=2, seed=3,
                                     workers=2, prefetch=4, device=dev,
                                     shard=None)
    got = [(ds.features.cpu(), ds.labels.cpu()) for ds in pipe]
    want = list(native._iter_py(native.NativePrefetchIterator(
        x, y, 128, epochs=2, seed=3)))
    assert len(got) == len(want) == 14
    for (a, b), (c, d) in zip(got, want):
        assert np.array_equal(a.numpy(), c) and np.array_equal(b.numpy(), d)


@pytest.mark.gpu
def test_kill_and_resume_of_a_char_rnn_is_bit_equal_on_card(tmp_path):
    """K1 and K2 give the same bits launch to launch, and the pipeline's
    copies stay off the compute stream: a run killed at step 5 and
    resumed from its step-4 checkpoint ends torch.equal to an
    uninterrupted one."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.etl.pipeline import InputPipeline
    from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_conf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch import resilience as pres

    v, n, t = 12, 8, 40
    rng = np.random.default_rng(4)
    idx = rng.integers(0, v, (48, t + 1))
    x = np.eye(v, dtype=np.float32)[idx[:, :-1]]
    y = np.eye(v, dtype=np.float32)[idx[:, 1:]]

    def net():
        conf = char_rnn_conf(v, lstm_size=32, num_layers=2, seed=5,
                             tbptt_length=20, learning_rate=0.01)
        return MultiLayerNetwork(conf, device=dev).init(input_shape=(1, v))

    def feed():
        return InputPipeline(ListDataSetIterator(x, y, n), workers=2,
                             prefetch=3, device=dev, shard=None)

    base = pres.ResilientTrainer(net(), device=dev)
    base.fit(feed(), num_epochs=2)
    mgr = pres.CheckpointManager(str(tmp_path), every_steps=4, keep_last=2)
    killed = pres.ResilientTrainer(net(), mgr, device=dev,
                                   chaos=pres.ChaosMonkey(
                                       pres.ChaosConfig(kill_at_step=5)))
    with pytest.raises(pres.InjectedKill):
        killed.fit(feed(), num_epochs=2)
    mgr.close()
    mgr2 = pres.CheckpointManager(str(tmp_path), every_steps=4, keep_last=2)
    resumed = pres.ResilientTrainer(net(), mgr2, device=dev)
    resumed.fit(feed(), num_epochs=2)
    mgr2.close()
    assert resumed.resumed_step == 4 and resumed.step == base.step == 12
    assert killed.losses[:4] + resumed.losses == base.losses
    for a, b in zip(tree_leaves(base.net.params),
                    tree_leaves(resumed.net.params)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2])
def test_index_form_moe_on_card_matches_dense_chain(k):
    """``moe_ffn`` (gather, ``torch.bmm`` experts, weighted sum in choice
    order) against the dense einsum chain on the card, f32, at a
    capacity that drops slots: outputs and gradients within 1e-4 of
    each one's largest entry (at top 1 the gate's gradient is rounding
    noise in both); two runs bit-equal."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.parallel import expert_parallel as pep

    p = pep.init_moe_params(0, 256, 512, 8, device=dev)
    x = torch.randn((4096, 256), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    cap = pep.capacity_of(1.0, 4096, k, 8)

    def run(fn):
        pp = {a: v.clone().requires_grad_() for a, v in p.items()}
        xx = x.clone().requires_grad_()
        y = fn(pp, xx)
        g = torch.autograd.grad((y ** 2).sum(), [xx] + list(pp.values()))
        return [y.detach()] + list(g)

    got = run(lambda pp, xx: pep.moe_ffn(xx, pp, top_k_=k,
                                         capacity=cap)[0])
    again = run(lambda pp, xx: pep.moe_ffn(xx, pp, top_k_=k,
                                           capacity=cap)[0])
    want = run(lambda pp, xx: pep.moe_reference(pp, xx, top_k_=k,
                                                capacity_factor=1.0))
    names = ["y", "x"] + list(p)
    for name, a, b, c in zip(names, got, want, again):
        assert torch.equal(a, c), name
        if k == 1 and name == "Wg":
            # top 1 renormalizes its one gate to 1: Wg's gradient is 0
            # but for rounding, in both, far below x's
            bar = 1e-4 * got[1].abs().max().item()
            assert max(a.abs().max().item(), b.abs().max().item()) <= bar
            continue
        scale = b.abs().max().item() or 1.0
        assert (a - b).abs().max().item() <= 1e-4 * scale, name


@pytest.mark.gpu
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_megatron_step_on_a_world1_nccl_group_equals_the_plain_step(
        moe, tmp_path):
    """A 2-layer LM's step on a data x model x expert mesh of world-1
    NCCL groups is ``torch.equal`` to the plain step (loss and every
    param), K4 and K7 once per layer in each."""
    dev = _need_card()
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.parallel.mesh import (
        device_mesh,
        init_seq_group,
    )

    cfg = pt.TransformerConfig(vocab_size=256, d_model=256, n_layers=2,
                               n_heads=4, d_ff=512, max_len=256, seed=3,
                               **({"moe_experts": 4} if moe else {}))
    params = pt.init_params(cfg, device=dev)
    ids = np.random.default_rng(2).integers(0, 256, (4, 257))
    x = torch.from_numpy(ids[:, :-1]).to(dev)
    y = torch.from_numpy(ids[:, 1:]).to(dev)
    k4, k7 = port_flash.flash_attention, port_flash.flash_bwd
    group = init_seq_group(str(tmp_path / "store"), 0, 1, backend="nccl")
    try:
        mesh = device_mesh((1, 1, 1), ("data", "model", "expert"))
        before = (k4.launches, k7.launches)
        p1, _, l1 = pt.make_train_step(cfg, mesh)(
            pt.shard_params(params, cfg, mesh), pt.init_opt_state(params),
            x, y)
        torch.cuda.synchronize()
        ran = (k4.launches - before[0], k7.launches - before[1])
    finally:
        dist.destroy_process_group()
    p0, _, l0 = pt.make_train_step(cfg)(params, pt.init_opt_state(params),
                                        x, y)
    assert ran == (cfg.n_layers, cfg.n_layers)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_averaging_master_in_process_workers_equal_explicit_reference():
    """4 in-process workers of ``ParameterAveragingTrainingMaster`` (no
    shuffle, frequency 2, one round) on an LSTM net: ``torch.equal`` to
    four nets fitted on their rows with params and RMSProp state averaged
    in worker order."""
    dev = _need_card()
    from deeplearning4j_tpu_torch.datasets.iterator import DataSet
    from deeplearning4j_tpu_torch.nn import conf as pconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import training_master as ptm
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        average_trees,
    )

    conf = (pconf.NeuralNetConfiguration.builder().seed(4)
            .learning_rate(0.01).updater("rmsprop").list()
            .layer(0, pconf.GravesLSTM(n_in=16, n_out=64, activation="tanh"))
            .layer(1, pconf.RnnOutputLayer(n_in=64, n_out=16,
                                           activation="softmax",
                                           loss_function="mcxent"))
            .build())
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 16, (64, 21))
    eye = np.eye(16, dtype=np.float32)
    x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]
    net = MultiLayerNetwork(conf, device=dev).init()
    ref = [MultiLayerNetwork(conf, device=dev).init() for _ in range(4)]
    master = ptm.ParameterAveragingTrainingMaster(
        num_workers=4, batch_size_per_worker=8, averaging_frequency=2,
        repartition=ptm.Repartition.NEVER, device=dev)
    master.execute_training(net, [DataSet(x, y)])
    for w, r in enumerate(ref):
        rows = lambda a, i: a[32 * i:32 * (i + 1)][8 * w:8 * (w + 1)]  # noqa
        for i in range(2):
            r.fit(rows(x, i), rows(y, i))
    params = average_trees([r.params for r in ref])
    upd = average_trees([r.updater_state for r in ref])
    for a, b in zip(tree_leaves(net.params), tree_leaves(params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(net.updater_state), tree_leaves(upd)):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
