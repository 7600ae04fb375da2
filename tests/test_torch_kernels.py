"""The port's two kernels against the JAX package (CPU) and against their
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
    output by a single bit. Tolerance 1e-5 abs (f32).

The same kernels on the card, against their plain versions, are in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the JAX reference side

from deeplearning4j_tpu_torch.ops import flash_attention as port_flash  # noqa: E402
from deeplearning4j_tpu_torch.ops import paged_attention as port_paged  # noqa: E402

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
