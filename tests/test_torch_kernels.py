"""The port's kernels against the JAX package (CPU) and against their
plain versions (card).

On the CPU each wrapper runs its plain PyTorch version, which is held
against the JAX function the TPU kernel implements:

  * K4 flash attention — the port's plain flash against JAX
    ``flash_attention(..., interpret=True)`` and its lse against
    ``_flash_raw(...)[1][:, 0, :]`` at T in {128, 256} (the widths the
    Pallas kernel takes), and against JAX ``dense_attention`` at ragged
    T in {8, 96, 192}; causal and full. Tolerance 1e-5 abs (f32).
  * K6 paged attention — the port's plain paged attention against JAX
    ``paged_attention(..., interpret=True)`` and the gather path, with
    lanes inside block 0, across blocks and at the full window; a trash
    block poisoned with 1e6 in K and -1e6 in V moves no active lane's
    output by a single bit. Tolerance 1e-5 abs (f32). Also at contexts
    one before, on and one after the card kernel's split boundary
    (``SPLIT_TOKENS``), a single token and the full window, f32 and bf16
    arenas, with the trash block poisoned in both packages.
  * K1 LSTM scan — the port's plain scan against JAX
    ``_lstm_scan_reference`` and ``lstm_pallas_scan(..., interpret=True)``
    on hs, h_T and c_T, and its cell sequence against
    ``_lstm_pallas_fwd_raw(..., interpret=True, emit_cs=True)``, at
    T in {1, 8, 13}. Tolerance 1e-5 abs in f32; the f64 scan against the
    f64 reference at 1e-12.
  * K2 LSTM scan backward — the port's plain reverse-time loop, fed the
    cell sequence of ``_lstm_pallas_fwd_raw(..., interpret=True,
    emit_cs=True)``, against ``_lstm_pallas_bwd_raw(..., interpret=True)``
    and ``jax.vjp`` of ``_lstm_scan_reference`` at (N, T, H) in
    {(4, 6, 8), (3, 64, 8) (several reverse time blocks), (2, 1, 8)}:
    f32 at 1e-5 abs (1e-4 abs on dU and dp, sums of N*T terms in another
    order), f64 against the f64 vjp at 1e-12. ``LstmScanFn`` passes
    ``torch.autograd.gradcheck`` in f64 and its gradients equal autograd
    through the plain forward at 1e-10 (f64), with and without cotangents
    on h_T and c_T. The cards' layout planner for K1 and K2
    (``plan_scan``: rows per cluster, cluster size, units per CTA, U rows
    in shared memory, shared-memory bytes) at the paths' shapes, N=1,
    ragged N and H, H=1000, the largest shape class, and its refusals.
  * K3 SGNS step — the port's plain step (``ops/sgns.sgns_step_plain``)
    against ``nlp/word2vec._neg_body`` in f32 at 1e-6 abs (the TPU kernel
    ``sgns_fused_step`` does not run on the installed jax, so its own
    oracle stands in), and the port's batch loop ``skipgram_batches``
    with the JAX draws replayed against ``_skipgram_epoch(...,
    sgns_kernel=False)`` at 1e-5 abs, syn1 included, also as a
    128-batch chunk's shape cut to a chunk of 3 and a tail of 2 through
    the one-batch function ``skipgram_step``; the f64 cases are in
    ``tests/test_torch_word2vec.py``. The kernel's host-side helpers:
    ``hit_lists`` (each row's hits in the order the kernel's owners sum
    them) against a numpy reference, a row of one hit and rows of ~190;
    ``workspace_sizes`` holds no [V, D] buffer; ``replay_draw`` reads the
    same negatives by an int and by a 0-d tensor index.

  * K7 flash backward — its wrapper ``flash_bwd`` sends CPU tensors to
    its plain version ``flash_block_bwd`` (held against the JAX
    ``_flash_ext_bwd`` in ``tests/test_torch_flash_ext.py``), and
    ``FlashFn``/``FlashBlockFn`` call it once per backward and give, on
    the CPU, the f64 gradients of autograd through the dense plain
    forward at 1e-10 (with a key mask, an lse cotangent, Tq != Tk and
    offsets past either end), and zero gradients for queries that see no
    key; K4's forward is one custom operator, the one the ``dots`` remat
    rung keeps.

The same kernels on the card, against their plain versions, are in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the JAX reference side

from deeplearning4j_tpu_torch.ops import flash_attention as port_flash  # noqa: E402
from deeplearning4j_tpu_torch.ops import lstm_scan as port_lstm  # noqa: E402
from deeplearning4j_tpu_torch.ops import paged_attention as port_paged  # noqa: E402
from deeplearning4j_tpu_torch.ops import sgns as port_sgns  # noqa: E402

TOL = 1e-5


def _qkv(seed, n, t, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _port(a, device="cpu", dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


# ---------------------------------------------------------------------------
# K4 — flash attention
# ---------------------------------------------------------------------------


class TestFlashPlainAgainstJax:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("t", [128, 256])
    def test_matches_pallas_kernel_interpret(self, t, causal):
        from deeplearning4j_tpu.ops.pallas_attention import (
            _flash_raw,
            flash_attention,
        )

        n, h, d = 1, 2, 16
        q, k, v = _qkv(t + causal, n, t, h, d)
        ref = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal,
                                         interpret=True))
        fold = lambda x: jnp.asarray(
            x.transpose(0, 2, 1, 3).reshape(n * h, t, d))
        ref_lse = np.asarray(_flash_raw(fold(q), fold(k), fold(v),
                                        causal=causal,
                                        interpret=True)[1][:, 0, :])
        o, lse = port_flash.flash_attention(_port(q), _port(k), _port(v),
                                            causal=causal)
        assert o.shape == (n, t, h, d) and lse.shape == (n, h, t)
        assert np.abs(o.numpy() - ref).max() < TOL
        assert np.abs(lse.numpy().reshape(n * h, t) - ref_lse).max() < TOL

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("t", [8, 96, 192])
    def test_ragged_widths_match_dense(self, t, causal):
        """Widths the Pallas kernel refuses (T % 128 != 0): the JAX
        package answers them with dense XLA attention; the port's flash
        path takes every width."""
        from deeplearning4j_tpu.ops.pallas_attention import dense_attention

        q, k, v = _qkv(7 * t + causal, 2, t, 3, 32)
        ref = np.asarray(dense_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal))
        o, _ = port_flash.flash_attention(_port(q), _port(k), _port(v),
                                          causal=causal)
        assert np.abs(o.numpy() - ref).max() < TOL

    def test_one_batch_loop_matches_skipgram_epoch_chunk_and_tail(self):
        """Five batches through ``skipgram_step`` in a plain Python loop
        (the body each card graph captures) against the JAX scan run as a
        chunk of three and a tail of two, the last batch partly padded,
        with the same keys' negatives."""
        import jax

        from deeplearning4j_tpu.nlp.word2vec import _skipgram_epoch
        from deeplearning4j_tpu_torch.nlp.word2vec import (
            ns_constants,
            skipgram_step,
        )

        rng = np.random.default_rng(8)
        v, vh, d, l = 40, 39, 16, 5
        nb, b, k = 5, 12, 4
        syn0 = rng.standard_normal((v, d)).astype(np.float32) * 0.1
        syn1 = rng.standard_normal((vh, d)).astype(np.float32) * 0.1
        syn1neg = rng.standard_normal((v, d)).astype(np.float32) * 0.1
        P = rng.integers(0, vh, size=(v, l))
        C = rng.integers(0, 2, size=(v, l)).astype(np.float32)
        M = rng.integers(0, 2, size=(v, l)).astype(np.float32)
        table = rng.integers(0, v, size=(64,))
        cens = rng.integers(0, v, size=(nb, b))
        cxs = rng.integers(0, v, size=(nb, b))
        plive = np.ones((nb, b), np.float32)
        plive[-1, 7:] = 0.0
        keys = jnp.stack([jax.random.PRNGKey(10 + i) for i in range(nb)])
        alphas = np.linspace(0.025, 0.02, nb).astype(np.float32)
        want = (jnp.array(syn0), jnp.array(syn1), jnp.array(syn1neg))
        for s0, s1 in ((0, 3), (3, 5)):
            want = _skipgram_epoch(
                *want, jnp.asarray(P, jnp.int32), jnp.asarray(C),
                jnp.asarray(M), jnp.asarray(table, jnp.int32),
                jnp.asarray(cens[s0:s1], jnp.int32),
                jnp.asarray(cxs[s0:s1], jnp.int32),
                jnp.asarray(plive[s0:s1]), keys[s0:s1],
                jnp.asarray(alphas[s0:s1]), use_neg=True, negative_k=k)
        tables = (_port(syn0), _port(syn1), _port(syn1neg))
        huffman = (torch.from_numpy(P), _port(C), _port(M))
        consts = ns_constants(b, k, torch.float32, "cpu")
        for j in range(nb):
            idx = jax.random.randint(keys[j], (b, k), 0, len(table))
            negatives = torch.from_numpy(table[np.asarray(idx)])
            skipgram_step(tables, huffman, torch.from_numpy(cens[j]),
                          torch.from_numpy(cxs[j]), _port(plive[j]),
                          _port(alphas[j]), negatives, *consts)
        for got, ref in zip(tables, want):
            assert np.abs(got.numpy() - np.asarray(ref)).max() < TOL

    def test_cpu_wrapper_counts_plain_calls_only(self):
        q, k, v = (_port(a) for a in _qkv(0, 1, 8, 2, 16))
        kern, plain = (port_flash.flash_attention.launches,
                       port_flash.flash_attention_plain.launches)
        port_flash.flash_attention(q, k, v, causal=True)
        assert port_flash.flash_attention.launches == kern
        assert port_flash.flash_attention_plain.launches == plain + 1


# ---------------------------------------------------------------------------
# K6 — paged decode attention
# ---------------------------------------------------------------------------


def _arena_case(seed, s=6, h=2, hd=16, bt=4, m=4):
    """Lane i owns distinct arena blocks (from 1; 0 is trash), its table
    padded with trash entries. Lane 0 sits inside block 0 of its table
    (pos 1), lane 1 at its first token (pos 0), lane 2 holds the full
    window (pos m*bt-1), the rest end mid-block across blocks."""
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


def _split_case(seed, contexts, h, hd, bt, m):
    """One lane per context (tokens 0 .. context - 1 visible), each on
    its own arena blocks (from 1; block 0 is trash), the rest of its
    table pointing at the trash block."""
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


def _jax_gather(q, ck, cv, tables, pos):
    """serving/paged.py's gather-path attention math."""
    import jax

    s, h, hd = q.shape
    bt = ck.shape[1]
    t_total = tables.shape[1] * bt
    kg = jnp.asarray(ck)[tables].reshape(s, t_total, h, hd)
    vg = jnp.asarray(cv)[tables].reshape(s, t_total, h, hd)
    sc = jnp.einsum("nhd,nthd->nht", jnp.asarray(q), kg) \
        / float(np.sqrt(hd))
    visible = jnp.arange(t_total)[None, :] <= jnp.asarray(pos)[:, None]
    sc = jnp.where(visible[:, None, :], sc, -jnp.inf)
    p = jax.nn.softmax(sc, axis=-1)
    return np.asarray(jnp.einsum("nht,nthd->nhd", p, vg))


class TestPagedPlainAgainstJax:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_pallas_kernel_and_gather(self, seed):
        from deeplearning4j_tpu.ops.pallas_paged import paged_attention

        q, ck, cv, tables, pos = _arena_case(seed)
        ref = np.asarray(paged_attention(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
            jnp.asarray(tables), jnp.asarray(pos), interpret=True))
        gather = _jax_gather(q, ck, cv, tables, pos)
        out = port_paged.paged_attention(
            _port(q), _port(ck), _port(cv), torch.from_numpy(tables),
            torch.from_numpy(pos)).numpy()
        assert out.dtype == np.float32 and out.shape == q.shape
        assert np.abs(out - ref).max() < TOL
        assert np.abs(out - gather).max() < TOL

    @pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
    def test_matches_pallas_kernel_at_split_boundaries(self, kv_dtype):
        """The card kernel cuts a lane's context into splits of
        SPLIT_TOKENS tokens, so its oracle, the plain version, is held to
        the Pallas kernel at contexts one before, on and one after a
        split boundary, at a single token and at the full window, with
        the trash block poisoned (K = 1e6, V = -1e6) in both."""
        from deeplearning4j_tpu.ops.pallas_paged import paged_attention

        st, bt = port_paged.SPLIT_TOKENS, 16
        m = st // bt + 2
        contexts = [st - 1, st, st + 1, 1, m * bt]
        q, ck, cv, tables, pos = _split_case(len(kv_dtype), contexts, h=2,
                                             hd=16, bt=bt, m=m)
        ck[0], cv[0] = 1e6, -1e6
        tdt = getattr(torch, kv_dtype)
        ckt, cvt = _port(ck, dtype=tdt), _port(cv, dtype=tdt)
        ref = np.asarray(paged_attention(
            jnp.asarray(q), jnp.asarray(ck, dtype=kv_dtype),
            jnp.asarray(cv, dtype=kv_dtype), jnp.asarray(tables),
            jnp.asarray(pos), interpret=True))
        out = port_paged.paged_attention(
            _port(q), ckt, cvt, torch.from_numpy(tables),
            torch.from_numpy(pos)).numpy()
        assert out.shape == q.shape and np.isfinite(out).all()
        assert np.abs(out - ref).max() < TOL

    def test_trash_block_content_is_invisible(self):
        q, ck, cv, tables, pos = _arena_case(2)
        args = (torch.from_numpy(tables), torch.from_numpy(pos))
        clean = port_paged.paged_attention(_port(q), _port(ck), _port(cv),
                                           *args).numpy()
        ck[0], cv[0] = 1e6, -1e6
        poisoned = port_paged.paged_attention(_port(q), _port(ck),
                                              _port(cv), *args).numpy()
        np.testing.assert_array_equal(clean, poisoned)

    def test_bf16_arena_takes_f32_math(self):
        """A bf16 arena is read in f32: the plain version equals the f32
        computation on the bf16-rounded values."""
        q, ck, cv, tables, pos = _arena_case(3)
        args = (torch.from_numpy(tables), torch.from_numpy(pos))
        ckb = _port(ck, dtype=torch.bfloat16)
        cvb = _port(cv, dtype=torch.bfloat16)
        out = port_paged.paged_attention(_port(q), ckb, cvb, *args)
        ref = _jax_gather(q, ckb.float().numpy(), cvb.float().numpy(),
                          tables, pos)
        assert np.abs(out.numpy() - ref).max() < TOL


# ---------------------------------------------------------------------------
# K1 — fused LSTM forward scan
# ---------------------------------------------------------------------------


def _lstm_case(seed, n=3, t=8, h=16, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, (n, t, 4 * h)).astype(dtype),
            rng.normal(0, 0.3, (h, 4 * h)).astype(dtype),
            rng.normal(0, 0.1, (3, h)).astype(dtype),
            rng.normal(0, 0.2, (n, h)).astype(dtype),
            rng.normal(0, 0.2, (n, h)).astype(dtype))


class TestLstmScanPlainAgainstJax:
    @pytest.mark.parametrize("t", [1, 8, 13])
    def test_matches_reference_and_pallas_kernel_interpret(self, t):
        from deeplearning4j_tpu.ops import pallas_kernels as pk

        args = _lstm_case(t, t=t)
        jargs = [jnp.asarray(a) for a in args]
        ref = pk._lstm_scan_reference(*jargs)
        kern = pk.lstm_pallas_scan(*jargs, True)
        hs_raw, cs_raw, _, _ = pk._lstm_pallas_fwd_raw(
            *jargs, interpret=True, emit_cs=True)
        hs, h_t, c_t, cs = port_lstm.lstm_scan(
            *(_port(a) for a in args), emit_cs=True)
        assert hs.shape == (3, t, 16) and cs.shape == (t, 3, 16)
        for ours, r, k in zip((hs, h_t, c_t), ref, kern):
            assert np.abs(ours.numpy() - np.asarray(r)).max() < TOL
            assert np.abs(ours.numpy() - np.asarray(k)).max() < TOL
        assert np.abs(hs.numpy() - np.asarray(hs_raw)).max() < TOL
        assert np.abs(cs.numpy() - np.asarray(cs_raw)).max() < TOL

    @pytest.mark.parametrize("t", [1, 8, 13])
    def test_f64_matches_f64_reference(self, t):
        from deeplearning4j_tpu.ops import pallas_kernels as pk

        args = _lstm_case(100 + t, t=t, dtype=np.float64)
        ref = pk._lstm_scan_reference(*(jnp.asarray(a) for a in args))
        assert ref[0].dtype == jnp.float64
        hs, h_t, c_t, cs = port_lstm.lstm_scan(
            *(torch.from_numpy(a) for a in args))
        assert cs is None and hs.dtype == torch.float64
        for ours, r in zip((hs, h_t, c_t), ref):
            assert np.abs(ours.numpy() - np.asarray(r)).max() < 1e-12

    def test_one_batch_loop_matches_skipgram_epoch_chunk_and_tail(self):
        """Five batches through ``skipgram_step`` in a plain Python loop
        (the body each card graph captures) against the JAX scan run as a
        chunk of three and a tail of two, the last batch partly padded,
        with the same keys' negatives."""
        import jax

        from deeplearning4j_tpu.nlp.word2vec import _skipgram_epoch
        from deeplearning4j_tpu_torch.nlp.word2vec import (
            ns_constants,
            skipgram_step,
        )

        rng = np.random.default_rng(8)
        v, vh, d, l = 40, 39, 16, 5
        nb, b, k = 5, 12, 4
        syn0 = rng.standard_normal((v, d)).astype(np.float32) * 0.1
        syn1 = rng.standard_normal((vh, d)).astype(np.float32) * 0.1
        syn1neg = rng.standard_normal((v, d)).astype(np.float32) * 0.1
        P = rng.integers(0, vh, size=(v, l))
        C = rng.integers(0, 2, size=(v, l)).astype(np.float32)
        M = rng.integers(0, 2, size=(v, l)).astype(np.float32)
        table = rng.integers(0, v, size=(64,))
        cens = rng.integers(0, v, size=(nb, b))
        cxs = rng.integers(0, v, size=(nb, b))
        plive = np.ones((nb, b), np.float32)
        plive[-1, 7:] = 0.0
        keys = jnp.stack([jax.random.PRNGKey(10 + i) for i in range(nb)])
        alphas = np.linspace(0.025, 0.02, nb).astype(np.float32)
        want = (jnp.array(syn0), jnp.array(syn1), jnp.array(syn1neg))
        for s0, s1 in ((0, 3), (3, 5)):
            want = _skipgram_epoch(
                *want, jnp.asarray(P, jnp.int32), jnp.asarray(C),
                jnp.asarray(M), jnp.asarray(table, jnp.int32),
                jnp.asarray(cens[s0:s1], jnp.int32),
                jnp.asarray(cxs[s0:s1], jnp.int32),
                jnp.asarray(plive[s0:s1]), keys[s0:s1],
                jnp.asarray(alphas[s0:s1]), use_neg=True, negative_k=k)
        tables = (_port(syn0), _port(syn1), _port(syn1neg))
        huffman = (torch.from_numpy(P), _port(C), _port(M))
        consts = ns_constants(b, k, torch.float32, "cpu")
        for j in range(nb):
            idx = jax.random.randint(keys[j], (b, k), 0, len(table))
            negatives = torch.from_numpy(table[np.asarray(idx)])
            skipgram_step(tables, huffman, torch.from_numpy(cens[j]),
                          torch.from_numpy(cxs[j]), _port(plive[j]),
                          _port(alphas[j]), negatives, *consts)
        for got, ref in zip(tables, want):
            assert np.abs(got.numpy() - np.asarray(ref)).max() < TOL

    def test_cpu_wrapper_counts_plain_calls_only(self):
        args = [_port(a) for a in _lstm_case(0)]
        kern, plain = (port_lstm.lstm_scan.launches,
                       port_lstm.lstm_scan_plain.launches)
        port_lstm.lstm_scan(*args)
        assert port_lstm.lstm_scan.launches == kern
        assert port_lstm.lstm_scan_plain.launches == plain + 1



def _h100_capacity(rows, cluster, smem):
    """A stand-in for cudaOccupancyMaxActiveClusters on an H100, one CTA
    per SM: 8 clusters of 16 CTAs, 16 of 8."""
    return 128 // cluster


def _plan(n, t, h, backward, capacity=_h100_capacity):
    return port_lstm.plan_scan(n, t, h, backward=backward, sms=132,
                               smem_limit=port_lstm.SMEM_OPTIN_H100,
                               capacity=capacity)


class TestScanPlan:
    """The kernels' layout planner (K1 and K2's sweep), a plain function."""

    @pytest.mark.parametrize("n,t,h,backward,rows,k_smem", [
        (64, 100, 200, False, 8, 200),   # /predict at batch 64: 8 x 16 CTAs
        (32, 50, 200, False, 4, 200),    # a training window's forward
        (32, 50, 200, True, 4, 200),     # and its backward
        (1, 8, 200, False, 1, 200),      # one row: one cluster
        (1, 8, 200, True, 1, 200),
        (70, 9, 300, False, 16, 300),    # ragged N: a partial row block
        (5, 12, 270, True, 1, 270),      # ragged H: the last CTA holds 14
        (5, 20, 1000, False, 1, 218),    # U's slice partly in L2
        (5, 20, 1000, True, 1, 221),
        (128, 512, 512, False, 16, 156),  # the largest shape class
        (128, 512, 512, True, 16, 300),
    ])
    def test_plan_at_the_paths_shapes(self, n, t, h, backward, rows,
                                      k_smem):
        pl = _plan(n, t, h, backward)
        assert (pl.rows, pl.k_smem) == (rows, k_smem)
        assert pl.rows in port_lstm.ROW_BLOCKS and pl.cluster == 16
        assert pl.units == -(-h // 16) and pl.units * pl.cluster >= h
        assert pl.blocks == -(-n // pl.rows)
        assert pl.blocks <= _h100_capacity(pl.rows, pl.cluster, pl.smem)
        assert pl.rows * pl.units <= port_lstm.MAX_OWNED * port_lstm.THREADS
        assert pl.smem <= port_lstm.SMEM_OPTIN_H100
        assert (pl.ksplit == 1) == backward or pl.units * 2 > 256
        assert pl.units * pl.ksplit <= port_lstm.THREADS
        assert (pl.du_splits >= 1) and (pl.du_splits == 1 or backward)

    def test_shared_memory_count_matches_the_kernels_layout(self):
        pl = _plan(64, 100, 200, False)
        # two 8-byte mbarriers, U's slice, then the kernel's tiles: h rows
        # of 8 padded to 12, each of the 16 k shares one float4 longer
        hbuf, red, hst = 2 * 200 * 12, 4 * 16 * (13 * 8 + 1), 13 * 8
        assert pl.smem == 16 + 4 * (4 * 200 * 13 + hbuf + red + hst)
        pl = _plan(32, 50, 200, True)
        dz, rb = 4 * 13 * 4, 2 * 16 * 13 * 4
        assert pl.smem == 16 + 4 * (4 * 200 * 13 + dz + rb)
        assert pl.du_splits == 5  # 52 tiles of dU x 5 ranges of 320 rows
        # 16 units a CTA: U's rows padded to 17 float4s (odd: no bank
        # conflicts between the k-share lanes)
        pl = _plan(32, 128, 256, True)
        assert (pl.units, pl.rows, pl.k_smem) == (16, 4, 256)
        dz, rb = 4 * 16 * 4, 2 * 16 * 16 * 4
        assert pl.smem == 16 + 4 * (4 * 256 * 17 + dz + rb)

    def test_clusters_of_8_where_16_do_not_schedule(self):
        pl = _plan(64, 100, 200, False,
                   capacity=lambda r, c, s: 0 if c == 16 else 16)
        assert (pl.cluster, pl.units, pl.rows, pl.blocks) == (8, 25, 4, 16)

    def test_more_rows_per_block_where_fewer_clusters_fit(self):
        pl = _plan(64, 100, 200, False, capacity=lambda r, c, s: 4)
        assert (pl.rows, pl.blocks) == (16, 4)
        # past 16 rows per block, row blocks run in waves
        pl = _plan(1000, 10, 200, True, capacity=lambda r, c, s: 4)
        assert (pl.rows, pl.blocks) == (16, 63)

    @pytest.mark.parametrize("h,capacity,why", [
        (4100, _h100_capacity, "257 units per CTA"),
        (200, lambda r, c, s: 0, "do not schedule"),
    ])
    def test_refuses_what_no_cluster_takes(self, h, capacity, why):
        with pytest.raises(ValueError, match="no cluster layout") as err:
            _plan(1, 8, h, False, capacity=capacity)
        assert why in str(err.value)


# ---------------------------------------------------------------------------
# K2 — fused LSTM backward scan
# ---------------------------------------------------------------------------


def _bwd_case(seed, n, t, h, dtype=np.float32):
    args = _lstm_case(seed, n=n, t=t, h=h, dtype=dtype)
    rng = np.random.default_rng(seed + 1000)
    cot = (rng.normal(0, 1, (n, t, h)).astype(dtype),
           rng.normal(0, 1, (n, h)).astype(dtype),
           rng.normal(0, 1, (n, h)).astype(dtype))
    return args, cot


BWD_SHAPES = [(4, 6, 8), (3, 64, 8), (2, 1, 8)]
BWD_NAMES = ("dxproj", "dU", "dp", "dh0", "dc0")
# dU and dp sum N*T products, in another order than XLA's
BWD_TOL_F32 = (1e-5, 1e-4, 1e-4, 1e-5, 1e-5)


class TestLstmScanBwdPlainAgainstJax:
    @pytest.mark.parametrize("n,t,h", BWD_SHAPES)
    def test_f32_matches_pallas_bwd_interpret_and_vjp(self, n, t, h):
        import jax

        from deeplearning4j_tpu.ops import pallas_kernels as pk

        args, cot = _bwd_case(n + t, n, t, h)
        jargs = [jnp.asarray(a) for a in args]
        jcot = tuple(jnp.asarray(c) for c in cot)
        hs_raw, cs_raw, _, _ = pk._lstm_pallas_fwd_raw(
            *jargs, interpret=True, emit_cs=True)
        kern = pk._lstm_pallas_bwd_raw(*jargs, cs_raw, hs_raw, *jcot,
                                       interpret=True)
        _, vjp = jax.vjp(pk._lstm_scan_reference, *jargs)
        ref = vjp(jcot)
        ours = port_lstm.lstm_scan_bwd(
            *(_port(a) for a in args), _port(np.array(cs_raw)),
            _port(np.array(hs_raw)), *(_port(c) for c in cot))
        for name, tol, o, k, r in zip(BWD_NAMES, BWD_TOL_F32, ours, kern,
                                      ref):
            assert o.shape == k.shape == r.shape, name
            assert np.abs(o.numpy() - np.asarray(k)).max() < tol, name
            assert np.abs(o.numpy() - np.asarray(r)).max() < tol, name

    @pytest.mark.parametrize("n,t,h", BWD_SHAPES)
    def test_f64_matches_f64_vjp(self, n, t, h):
        import jax

        from deeplearning4j_tpu.ops import pallas_kernels as pk

        args, cot = _bwd_case(200 + n + t, n, t, h, dtype=np.float64)
        jargs = [jnp.asarray(a) for a in args]
        _, vjp = jax.vjp(pk._lstm_scan_reference, *jargs)
        ref = vjp(tuple(jnp.asarray(c) for c in cot))
        assert ref[0].dtype == jnp.float64
        targs = [torch.from_numpy(a) for a in args]
        hs, _, _, cs = port_lstm.lstm_scan(*targs, emit_cs=True)
        ours = port_lstm.lstm_scan_bwd(*targs, cs, hs,
                                       *(torch.from_numpy(c) for c in cot))
        for name, o, r in zip(BWD_NAMES, ours, ref):
            assert o.dtype == torch.float64, name
            assert np.abs(o.numpy() - np.asarray(r)).max() < 1e-12, name

    def test_one_batch_loop_matches_skipgram_epoch_chunk_and_tail(self):
        """Five batches through ``skipgram_step`` in a plain Python loop
        (the body each card graph captures) against the JAX scan run as a
        chunk of three and a tail of two, the last batch partly padded,
        with the same keys' negatives."""
        import jax

        from deeplearning4j_tpu.nlp.word2vec import _skipgram_epoch
        from deeplearning4j_tpu_torch.nlp.word2vec import (
            ns_constants,
            skipgram_step,
        )

        rng = np.random.default_rng(8)
        v, vh, d, l = 40, 39, 16, 5
        nb, b, k = 5, 12, 4
        syn0 = rng.standard_normal((v, d)).astype(np.float32) * 0.1
        syn1 = rng.standard_normal((vh, d)).astype(np.float32) * 0.1
        syn1neg = rng.standard_normal((v, d)).astype(np.float32) * 0.1
        P = rng.integers(0, vh, size=(v, l))
        C = rng.integers(0, 2, size=(v, l)).astype(np.float32)
        M = rng.integers(0, 2, size=(v, l)).astype(np.float32)
        table = rng.integers(0, v, size=(64,))
        cens = rng.integers(0, v, size=(nb, b))
        cxs = rng.integers(0, v, size=(nb, b))
        plive = np.ones((nb, b), np.float32)
        plive[-1, 7:] = 0.0
        keys = jnp.stack([jax.random.PRNGKey(10 + i) for i in range(nb)])
        alphas = np.linspace(0.025, 0.02, nb).astype(np.float32)
        want = (jnp.array(syn0), jnp.array(syn1), jnp.array(syn1neg))
        for s0, s1 in ((0, 3), (3, 5)):
            want = _skipgram_epoch(
                *want, jnp.asarray(P, jnp.int32), jnp.asarray(C),
                jnp.asarray(M), jnp.asarray(table, jnp.int32),
                jnp.asarray(cens[s0:s1], jnp.int32),
                jnp.asarray(cxs[s0:s1], jnp.int32),
                jnp.asarray(plive[s0:s1]), keys[s0:s1],
                jnp.asarray(alphas[s0:s1]), use_neg=True, negative_k=k)
        tables = (_port(syn0), _port(syn1), _port(syn1neg))
        huffman = (torch.from_numpy(P), _port(C), _port(M))
        consts = ns_constants(b, k, torch.float32, "cpu")
        for j in range(nb):
            idx = jax.random.randint(keys[j], (b, k), 0, len(table))
            negatives = torch.from_numpy(table[np.asarray(idx)])
            skipgram_step(tables, huffman, torch.from_numpy(cens[j]),
                          torch.from_numpy(cxs[j]), _port(plive[j]),
                          _port(alphas[j]), negatives, *consts)
        for got, ref in zip(tables, want):
            assert np.abs(got.numpy() - np.asarray(ref)).max() < TOL

    def test_cpu_wrapper_counts_plain_calls_only(self):
        args, cot = _bwd_case(0, 3, 8, 16)
        targs = [_port(a) for a in args]
        hs, _, _, cs = port_lstm.lstm_scan(*targs, emit_cs=True)
        kern, plain = (port_lstm.lstm_scan_bwd.launches,
                       port_lstm.lstm_scan_bwd_plain.launches)
        port_lstm.lstm_scan_bwd(*targs, cs, hs, *(_port(c) for c in cot))
        assert port_lstm.lstm_scan_bwd.launches == kern
        assert port_lstm.lstm_scan_bwd_plain.launches == plain + 1


def _grad_inputs(seed, n=3, t=9, h=5):
    return [torch.from_numpy(a).requires_grad_()
            for a in _lstm_case(seed, n=n, t=t, h=h, dtype=np.float64)]


class TestLstmScanFn:
    def test_gradcheck_f64(self):
        assert torch.autograd.gradcheck(port_lstm.LstmScanFn.apply,
                                        _grad_inputs(0, n=2, t=4, h=3))

    @pytest.mark.parametrize("outputs", ["all", "hs_only", "final_only"])
    def test_gradients_equal_autograd_through_the_plain_scan(self, outputs):
        """Weighted sums of the outputs the case uses; an unused output
        reaches the backward as zeros."""
        args = _grad_inputs(11)
        rng = np.random.default_rng(5)
        use = {"all": (0, 1, 2), "hs_only": (0,), "final_only": (1, 2)}[
            outputs]

        def loss(outs):
            return sum((outs[i] * torch.from_numpy(
                rng.standard_normal(tuple(outs[i].shape)))).sum()
                for i in use)

        got = torch.autograd.grad(loss(port_lstm.LstmScanFn.apply(*args)),
                                  args)
        rng = np.random.default_rng(5)
        want = torch.autograd.grad(
            loss(port_lstm.lstm_scan_plain(*args)[:3]), args)
        for g, w in zip(got, want):
            assert g.dtype == torch.float64
            assert (g - w).abs().max().item() < 1e-10

    def test_forward_emits_cs_and_backward_runs_k2(self):
        args = _grad_inputs(3)
        fwd, bwd = (port_lstm.lstm_scan_plain.launches,
                    port_lstm.lstm_scan_bwd_plain.launches)
        hs, h_t, c_t = port_lstm.LstmScanFn.apply(*args)
        assert port_lstm.lstm_scan_plain.launches == fwd + 1
        (hs.sum() + c_t.sum()).backward()
        assert port_lstm.lstm_scan_bwd_plain.launches == bwd + 1
        assert all(a.grad is not None for a in args)


def _sgns_case(seed, v=50, d=36, b=16, k1=6, scale=0.1):
    """f32 tables and a batch with a repeated context, colliding target
    rows, a dead negative and a fully dead pair."""
    rng = np.random.default_rng(seed)
    syn0 = (rng.standard_normal((v, d)) * scale).astype(np.float32)
    syn1neg = (rng.standard_normal((v, d)) * scale).astype(np.float32)
    cx = rng.integers(0, v, size=(b,))
    cx[5] = cx[4]
    tgt = rng.integers(0, v, size=(b, k1))
    tgt[3] = tgt[2]
    labels = np.zeros((b, k1), np.float32)
    labels[:, 0] = 1.0
    live = np.ones((b, k1), np.float32)
    live[1, 2] = 0.0
    live[7, :] = 0.0
    return syn0, syn1neg, cx, tgt, labels, live


class TestSgnsPlainAgainstJax:
    @pytest.mark.parametrize("seed,scale", [(3, 0.1), (11, 4.0)],
                             ids=["small", "saturated"])
    def test_f32_matches_neg_body(self, seed, scale):
        from deeplearning4j_tpu.nlp.word2vec import _neg_body

        syn0, syn1neg, cx, tgt, lbl, live = _sgns_case(seed, scale=scale)
        r0, r1 = _neg_body(jnp.asarray(syn0), jnp.asarray(syn1neg),
                           jnp.asarray(cx), jnp.asarray(tgt),
                           jnp.asarray(lbl), jnp.asarray(live), 0.025)
        p0, p1 = _port(syn0), _port(syn1neg)
        port_sgns.sgns_step(p0, p1, torch.from_numpy(cx),
                            torch.from_numpy(tgt), _port(lbl), _port(live),
                            0.025)
        assert p0.dtype == torch.float32
        assert np.abs(p0.numpy() - np.asarray(r0)).max() < 1e-6
        assert np.abs(p1.numpy() - np.asarray(r1)).max() < 1e-6

    def test_batch_loop_matches_skipgram_epoch(self):
        """The shape of the JAX package's epoch contract: 3 stacked batches,
        the last one partly padded, negatives drawn with the same keys."""
        import jax

        from deeplearning4j_tpu.nlp.word2vec import _skipgram_epoch
        from deeplearning4j_tpu_torch.nlp.word2vec import skipgram_batches

        rng = np.random.default_rng(5)
        v, vh, d, l = 30, 40, 24, 4
        nb, b, k = 3, 8, 5
        syn0 = rng.standard_normal((v, d)).astype(np.float32) * 0.1
        syn1 = rng.standard_normal((vh, d)).astype(np.float32) * 0.1
        syn1neg = rng.standard_normal((v, d)).astype(np.float32) * 0.1
        P = rng.integers(0, vh, size=(v, l))
        C = rng.integers(0, 2, size=(v, l)).astype(np.float32)
        M = rng.integers(0, 2, size=(v, l)).astype(np.float32)
        table = rng.integers(0, v, size=(64,))
        cens = rng.integers(0, v, size=(nb, b))
        cxs = rng.integers(0, v, size=(nb, b))
        plive = np.ones((nb, b), np.float32)
        plive[2, 6:] = 0.0
        keys = jnp.stack([jax.random.PRNGKey(i) for i in range(nb)])
        alphas = np.full((nb,), 0.025, np.float32)
        want = _skipgram_epoch(
            jnp.array(syn0), jnp.array(syn1), jnp.array(syn1neg),
            jnp.asarray(P, jnp.int32), jnp.asarray(C), jnp.asarray(M),
            jnp.asarray(table, jnp.int32), jnp.asarray(cens, jnp.int32),
            jnp.asarray(cxs, jnp.int32), jnp.asarray(plive), keys,
            jnp.asarray(alphas), use_neg=True, negative_k=k)
        t_table = torch.from_numpy(table)

        def draw(i):
            idx = jax.random.randint(keys[i], (b, k), 0, len(table))
            return t_table[torch.from_numpy(np.array(idx, np.int64))]

        tables = (_port(syn0), _port(syn1), _port(syn1neg))
        before = port_sgns.sgns_step_plain.launches
        skipgram_batches(tables, (torch.from_numpy(P), _port(C), _port(M)),
                         torch.from_numpy(cens), torch.from_numpy(cxs),
                         _port(plive), _port(alphas), negative=k, draw=draw)
        assert port_sgns.sgns_step_plain.launches == before + nb
        for got, ref in zip(tables, want):
            assert np.abs(got.numpy() - np.asarray(ref)).max() < TOL

    def test_one_batch_loop_matches_skipgram_epoch_chunk_and_tail(self):
        """Five batches through ``skipgram_step`` in a plain Python loop
        (the body each card graph captures) against the JAX scan run as a
        chunk of three and a tail of two, the last batch partly padded,
        with the same keys' negatives."""
        import jax

        from deeplearning4j_tpu.nlp.word2vec import _skipgram_epoch
        from deeplearning4j_tpu_torch.nlp.word2vec import (
            ns_constants,
            skipgram_step,
        )

        rng = np.random.default_rng(8)
        v, vh, d, l = 40, 39, 16, 5
        nb, b, k = 5, 12, 4
        syn0 = rng.standard_normal((v, d)).astype(np.float32) * 0.1
        syn1 = rng.standard_normal((vh, d)).astype(np.float32) * 0.1
        syn1neg = rng.standard_normal((v, d)).astype(np.float32) * 0.1
        P = rng.integers(0, vh, size=(v, l))
        C = rng.integers(0, 2, size=(v, l)).astype(np.float32)
        M = rng.integers(0, 2, size=(v, l)).astype(np.float32)
        table = rng.integers(0, v, size=(64,))
        cens = rng.integers(0, v, size=(nb, b))
        cxs = rng.integers(0, v, size=(nb, b))
        plive = np.ones((nb, b), np.float32)
        plive[-1, 7:] = 0.0
        keys = jnp.stack([jax.random.PRNGKey(10 + i) for i in range(nb)])
        alphas = np.linspace(0.025, 0.02, nb).astype(np.float32)
        want = (jnp.array(syn0), jnp.array(syn1), jnp.array(syn1neg))
        for s0, s1 in ((0, 3), (3, 5)):
            want = _skipgram_epoch(
                *want, jnp.asarray(P, jnp.int32), jnp.asarray(C),
                jnp.asarray(M), jnp.asarray(table, jnp.int32),
                jnp.asarray(cens[s0:s1], jnp.int32),
                jnp.asarray(cxs[s0:s1], jnp.int32),
                jnp.asarray(plive[s0:s1]), keys[s0:s1],
                jnp.asarray(alphas[s0:s1]), use_neg=True, negative_k=k)
        tables = (_port(syn0), _port(syn1), _port(syn1neg))
        huffman = (torch.from_numpy(P), _port(C), _port(M))
        consts = ns_constants(b, k, torch.float32, "cpu")
        for j in range(nb):
            idx = jax.random.randint(keys[j], (b, k), 0, len(table))
            negatives = torch.from_numpy(table[np.asarray(idx)])
            skipgram_step(tables, huffman, torch.from_numpy(cens[j]),
                          torch.from_numpy(cxs[j]), _port(plive[j]),
                          _port(alphas[j]), negatives, *consts)
        for got, ref in zip(tables, want):
            assert np.abs(got.numpy() - np.asarray(ref)).max() < TOL

    def test_cpu_wrapper_counts_plain_calls_only(self):
        syn0, syn1neg, cx, tgt, lbl, live = _sgns_case(0)
        kern, plain = (port_sgns.sgns_step.launches,
                       port_sgns.sgns_step_plain.launches)
        port_sgns.sgns_step(_port(syn0), _port(syn1neg),
                            torch.from_numpy(cx), torch.from_numpy(tgt),
                            _port(lbl), _port(live), 0.025)
        assert port_sgns.sgns_step.launches == kern
        assert port_sgns.sgns_step_plain.launches == plain + 1

    def test_wrapper_refuses_other_devices(self):
        t = torch.zeros((4, 8), device="meta")
        idx = torch.zeros((2,), dtype=torch.int64, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            port_sgns.sgns_step(t, t, idx, idx[:, None], t[:2, :1],
                                t[:2, :1], 0.025)


def _hit_lists_numpy(cx, tgt, live):
    """Per table, {row: [hit indices ascending]} with the kernel's
    numbering (targets b*(K+1) + k, contexts B*(K+1) + b)."""
    b, k1 = tgt.shape
    syn0, syn1neg = {}, {}
    for i in range(b):
        for k in range(k1):
            if live[i, k] != 0:
                syn1neg.setdefault(int(tgt[i, k]), []).append(i * k1 + k)
        if live[i].sum() > 0:
            syn0.setdefault(int(cx[i]), []).append(b * k1 + i)
    return syn0, syn1neg


class TestSgnsHostHelpers:
    @pytest.mark.parametrize("v,b,k1,dead", [
        (500, 16, 6, False), (5000, 8, 3, True), (64, 2048, 6, False),
        (64, 2048, 6, True)],
        ids=["one-hit-rows", "dead", "190-hits", "190-hits-dead"])
    def test_hit_lists_match_numpy(self, v, b, k1, dead):
        rng = np.random.default_rng(v + b)
        cx = rng.integers(0, v, size=(b,))
        tgt = rng.integers(0, v, size=(b, k1))
        live = np.ones((b, k1), np.float32)
        if dead:
            live[rng.random((b, k1)) < 0.3] = 0.0
            live[::7] = 0.0
        got = port_sgns.hit_lists(torch.from_numpy(cx),
                                  torch.from_numpy(tgt), _port(live))
        want = _hit_lists_numpy(cx, tgt, live)
        for (rows, starts, hits), ref in zip(got, want):
            assert rows.tolist() == sorted(ref)
            assert starts[0] == 0 and starts[-1] == hits.numel()
            for r, a, e in zip(rows.tolist(), starts[:-1].tolist(),
                               starts[1:].tolist()):
                assert hits[a:e].tolist() == ref[r]
        lengths = [np.diff(t[1].numpy()) for t in got]
        if v == 64:  # ~190 hits a syn1neg row: the owner CTA's path
            assert port_sgns.SLOTS > port_sgns.WARP_HITS
            assert lengths[1].max() > port_sgns.SLOTS
            assert lengths[1].mean() > 100
        elif not dead:
            assert lengths[1].min() == 1

    def test_hit_lists_of_a_row_hit_once(self):
        cx = torch.tensor([3, 4])
        tgt = torch.tensor([[7, 8], [9, 8]])
        live = torch.tensor([[1.0, 1.0], [1.0, 0.0]])
        (r0, s0, h0), (r1, s1, h1) = port_sgns.hit_lists(cx, tgt, live)
        assert (r0.tolist(), s0.tolist(), h0.tolist()) == \
            ([3, 4], [0, 1, 2], [4, 5])
        assert (r1.tolist(), s1.tolist(), h1.tolist()) == \
            ([7, 8, 9], [0, 1, 2, 3], [0, 1, 2])

    @pytest.mark.parametrize("v,d,b,k1", [(71290, 128, 2048, 6),
                                          (100_000, 100, 1024, 6),
                                          (64, 128, 2048, 6)])
    def test_workspace_holds_no_table_sized_buffer(self, v, d, b, k1):
        sizes = port_sgns.workspace_sizes(v, d, b, k1)
        h = b * (k1 + 1)
        assert sizes["head0"][0] == sizes["head1"][0] == v
        assert sizes["count"][0] == sizes["hit_row"][0] == h
        assert sizes["slots"][0] == h * port_sgns.SLOTS
        assert sizes["l1"][0] == sizes["neu1e"][0] == b * d
        assert all(n < v * d or v * d <= b * d for n, _ in sizes.values())
        nbytes = sum(4 * n for n, _ in sizes.values())
        if v > b:
            assert nbytes < v * d * 4 / 5

    def test_replay_draw_by_int_and_by_tensor(self):
        from deeplearning4j_tpu_torch.nlp.word2vec import replay_draw

        negatives = torch.arange(4 * 6 * 3).reshape(4, 6, 3)
        draw = replay_draw(negatives)
        for i in range(4):
            assert torch.equal(draw(i), negatives[i])
            assert torch.equal(draw(torch.tensor(i)), negatives[i])


class TestBuildTarget:
    """``ops/build._target``, the library path a source builds to: a
    digest of the source, every ``csrc/*.cuh`` and the flags, so an edited
    shared header rebuilds every library (no ``nvcc`` needed here)."""

    @pytest.mark.parametrize("change", ["header", "new_header", "flag",
                                        "variant_flag", "second_source"])
    def test_a_changed_input_gives_a_new_target(self, change, tmp_path,
                                                monkeypatch):
        from deeplearning4j_tpu_torch.ops import build

        (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
        (tmp_path / "k2.cu").write_text("// one\n")
        (tmp_path / "shared.cuh").write_text("// one\n")
        monkeypatch.setattr(build, "CSRC", tmp_path)
        monkeypatch.setattr(build, "LIBRARIES", {"k": ("k.cu", "k2.cu")})
        before = build._target("k")
        assert build._target("k") == before  # unchanged inputs: reused
        flags = ()
        if change == "header":
            (tmp_path / "shared.cuh").write_text("// two\n")
        elif change == "new_header":
            (tmp_path / "other.cuh").write_text("")
        elif change == "flag":
            monkeypatch.setattr(build, "NVCC_FLAGS",
                                build.NVCC_FLAGS + ("-lcuda",))
        elif change == "variant_flag":
            flags = ("-DFLASH_P_SPLIT=0",)
        else:
            (tmp_path / "k2.cu").write_text("// two\n")
        after = build._target("k", flags)
        assert after != before
        assert after.parent == before.parent
        assert after.name.startswith("libk-")

    def test_k4_and_k5_share_the_kernel_header(self):
        """K5's launcher includes the kernel header, K4's calls K5's entry
        point, and both build into one library: the kernels compile
        once."""
        from deeplearning4j_tpu_torch.ops import build

        k4, k5 = build.sources("flash_attention")
        assert (k4.name, k5.name) == ("flash_attention.cu",
                                      "flash_attention_ext.cu")
        assert '#include "flash_fwd.cuh"' in k5.read_text()
        k4_src = k4.read_text()
        assert "#include" not in k4_src
        assert "return flash_attention_ext_fwd(" in k4_src

    def test_k7_shares_the_primitives_not_the_forward(self):
        """K7 (its own library) and the forward include one header of
        primitives; K7 does not include the forward, so its library holds
        only its own kernels (what its SASS check reads)."""
        from deeplearning4j_tpu_torch.ops import build

        (k7,) = build.sources("flash_bwd")
        fwd = build.CSRC / "flash_fwd.cuh"
        for src in (k7, fwd):
            assert '#include "flash_tc.cuh"' in src.read_text()
        assert "flash_fwd.cuh" not in k7.read_text()

    def test_sass_functions_splits_by_kernel(self):
        from deeplearning4j_tpu_torch.ops import build

        text = ("\n\tcode for sm_90a\n"
                "\t\tFunction : _Z3fooI13__nv_bfloat16Li64EEvv\n"
                "\t.headerflags @\"EF_CUDA_SM90\"\n"
                "        /*0000*/ HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4] ;\n"
                "        /*0010*/ LDGSTS.E.BYPASS.128 [R3], desc[UR6][R4] ;\n"
                "\t\tFunction : _Z3fooIfLi64EEvv\n"
                "        /*0000*/ HMMA.1688.F32.TF32 R8, R4, R2, R8 ;\n")
        funcs = build.sass_functions(text)
        assert list(funcs) == ["_Z3fooI13__nv_bfloat16Li64EEvv",
                               "_Z3fooIfLi64EEvv"]
        bf16, f32 = funcs.values()
        assert "HGMMA" in bf16 and "LDGSTS" in bf16 and "HMMA" not in bf16
        assert "TF32" in f32 and "HGMMA" not in f32
        assert build.sass_functions("no kernels here") == {}


class TestFlashLaunchArguments:
    """``ops/flash_attention._check_inputs``, which the K4 and K5 wrappers
    run before every launch: (n, h, d) and the [N, T, H] strides of q, k
    and v in the order the C entry points take them, or a ValueError."""

    def test_strided_views_give_their_own_strides(self):
        x = torch.zeros((2, 130, 3, 2 * 64))
        q, k = x[..., :64], x[..., 64:]
        v = torch.zeros((2, 3, 130, 64)).permute(0, 2, 1, 3)
        (n, h, d), strides = port_flash._check_inputs(
            "t", q, k, v, same_t=True)
        assert (n, h, d) == (2, 3, 64)
        assert strides == q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
        assert strides[:3] == (130 * 3 * 128, 3 * 128, 128)
        assert strides[6:] == (3 * 130 * 64, 64, 130 * 64)

    @pytest.mark.parametrize("bad", ["shape", "head", "dtype", "last_axis"])
    def test_refuses_what_the_kernels_do_not_take(self, bad):
        q = torch.zeros((1, 8, 2, 64))
        k = v = q
        if bad == "shape":
            k = torch.zeros((1, 9, 2, 64))
        elif bad == "head":
            q = k = v = torch.zeros((1, 8, 2, 48))
        elif bad == "dtype":
            k = q.to(torch.bfloat16)
        else:
            v = torch.zeros((1, 8, 64, 2)).transpose(-1, -2)
        with pytest.raises(ValueError):
            port_flash._check_inputs("t", q, k, v, same_t=True)


class TestFlashBwdHostSide:
    """K7's wrapper and autograd functions on the CPU."""

    def test_cpu_tensors_route_to_the_plain_backward(self):
        rng = np.random.default_rng(0)
        q, k, v = (_port(rng.standard_normal((2, 40, 3, 16))
                         .astype(np.float32)) for _ in range(3))
        km = _port((rng.random((2, 40)) < 0.8).astype(np.float32))
        o, lse = port_flash.flash_attention_block_plain(q, k, v, offset=5,
                                                        key_mask=km)
        g = _port(rng.standard_normal((2, 40, 3, 16)).astype(np.float32))
        g_lse = _port(rng.standard_normal((2, 3, 40)).astype(np.float32))
        args = (q, k, v, km, 5, o, lse, g, g_lse)
        before = (port_flash.flash_bwd.launches,
                  port_flash.flash_block_bwd.launches)
        got = port_flash.flash_bwd(*args)
        assert (port_flash.flash_bwd.launches,
                port_flash.flash_block_bwd.launches) == (before[0],
                                                         before[1] + 1)
        for a, b in zip(got, port_flash.flash_block_bwd(*args)):
            assert torch.equal(a, b)

    def test_autograd_functions_call_the_backward_once(self):
        rng = np.random.default_rng(1)
        ins = [_port(rng.standard_normal((1, 20, 2, 16)).astype(np.float32))
               .requires_grad_() for _ in range(3)]
        before = port_flash.flash_block_bwd.launches
        o = port_flash.FlashFn.apply(*ins, True)
        torch.autograd.grad(o.sum(), ins)
        o, lse = port_flash.FlashBlockFn.apply(*ins, None, 3)
        torch.autograd.grad(o.sum() + lse.sum(), ins)
        assert port_flash.flash_block_bwd.launches == before + 2

    @pytest.mark.parametrize("tq,tk,offset,masked", [
        (64, 64, 0, False), (64, 64, 64, False), (40, 40, 5, True),
        (30, 50, 20, True), (50, 30, 0, True), (1, 1, 0, False),
        (17, 130, 130, True), (130, 130, 0, False), (20, 37, 1000, True)])
    def test_block_fn_gradients_equal_autograd_of_the_plain_forward_f64(
            self, tq, tk, offset, masked):
        """FlashBlockFn's backward (the plain K7 on the CPU) against
        autograd through the dense plain forward, in f64 at 1e-10; every
        query sees key 0 (offset >= 0, key 0 kept), so the dense
        logsumexp has a finite gradient everywhere."""
        rng = np.random.default_rng(tq * 1000 + tk)
        q, k, v = (_port(rng.standard_normal((2, t, 3, 16)),
                         dtype=torch.float64).requires_grad_()
                   for t in (tq, tk, tk))
        km = None
        if masked:
            km = _port(rng.random((2, tk)) < 0.7, dtype=torch.float64)
            km[:, 0] = 1.0
        g = _port(rng.standard_normal((2, tq, 3, 16)), dtype=torch.float64)
        g_lse = _port(rng.standard_normal((2, 3, tq)), dtype=torch.float64)
        o, lse = port_flash.FlashBlockFn.apply(q, k, v, km, offset)
        got = torch.autograd.grad((o * g).sum() + (lse * g_lse).sum(),
                                  (q, k, v))
        o, lse = port_flash.flash_attention_block_plain(q, k, v,
                                                        offset=offset,
                                                        key_mask=km)
        want = torch.autograd.grad((o * g).sum() + (lse * g_lse).sum(),
                                   (q, k, v))
        for a, b in zip(got, want):
            assert a.dtype == torch.float64
            assert (a - b).abs().max().item() <= 1e-10

    def test_queries_and_keys_out_of_sight_get_zero_gradients(self):
        """offset -8 hides every key from queries 0-7 (lse -inf) and keys
        Tq-8.. from every query: their gradients are 0, none is NaN."""
        rng = np.random.default_rng(3)
        q, k, v = (_port(rng.standard_normal((2, 24, 2, 16)))
                   .requires_grad_() for _ in range(3))
        o, lse = port_flash.FlashBlockFn.apply(q, k, v, None, -8)
        assert torch.isneginf(lse[:, :, :8]).all()
        g = _port(rng.standard_normal((2, 24, 2, 16)))
        dq, dk, dv = torch.autograd.grad((o * g).sum(), (q, k, v))
        assert all(torch.isfinite(a).all() for a in (dq, dk, dv))
        assert not dq[:, :8].any() and dq[:, 8:].abs().max() > 0
        assert not dk[:, 16:].any() and not dv[:, 16:].any()
        assert dv[:, :16].abs().max() > 0

    def test_k4_forward_is_one_operator_kept_by_dots(self):
        from deeplearning4j_tpu_torch.ops import remat

        op = torch.ops.dl4j_tpu_torch.flash_attention
        assert op.default in remat.saved_ops()
        q, k, v = (_port(a) for a in _qkv(2, 1, 24, 2, 16))
        o, lse = op(q, k, v, True)
        ro, rlse = port_flash.flash_attention_plain(q, k, v, causal=True)
        assert torch.equal(o, ro) and torch.equal(lse, rlse)
