"""K5 (flash attention with a key bias and a visibility offset), its
blocked backward, K4's backward and the attention dispatch of the port,
against the JAX package on the CPU.

On the CPU ``flash_attention_block`` runs its plain version
(``flash_attention_block_plain``), held against the JAX package's
``flash_attention_block(..., interpret=True)`` (the Pallas kernel run in
interpret mode) and against ``_dense_masked``:

  * every offset class: 0 (causal), Tk and past it (every key), between
    (a partial band, both signs), -Tq and below (no key: O exactly 0, lse
    exactly -inf), at Tq = Tk and Tq != Tk, with and without a key mask;
    a batch row with every key masked (O = 0, lse = -inf); f32 at 1e-5
    abs on O and on the finite lse, and the -inf rows equal;
  * ``flash_attention_masked`` against ``_dense_masked`` at ragged T
    (the Pallas kernel takes T % 128 only), causal and not;
  * ``FlashBlockFn``'s gradients, with cotangents on both O and lse,
    against ``jax.vjp`` of the same JAX function, at 1e-5 abs;
  * ``FlashFn`` (K4 forward, the blocked backward) against ``jax.vjp`` of
    JAX ``flash_attention(..., interpret=True)``, causal and not, at 1e-5
    abs, and against autograd through the dense plain version at ragged
    T in f64 at 1e-10;
  * ``attention_auto``: a mask goes to K5's path, none to K4's (counted
    on the plain versions), matching JAX ``attention_auto``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.ops import flash_attention as pf  # noqa: E402

TOL = 1e-5
N, H, D = 2, 2, 16


def _case(seed, tq, tk, masked, all_masked_row=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((N, tq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((N, tk, H, D)).astype(np.float32)
            for _ in range(2))
    km = None
    if masked:
        km = (rng.random((N, tk)) < 0.7).astype(np.float32)
        if all_masked_row:
            km[1] = 0.0
    return q, k, v, km


def _fold(x):
    n, t, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(n * h, t, d))


def _unfold(x, t):
    return np.asarray(x).reshape(N, H, t, D).transpose(0, 2, 1, 3)


def _jax_block(q, k, v, km, offset):
    """The JAX package's K5 path on [N, T, H, D] numpy inputs: a function
    of folded (q, k, v) for ``jax.vjp``, and the folded key mask."""
    from deeplearning4j_tpu.ops.pallas_attention import flash_attention_block

    kmj = None if km is None else jnp.asarray(np.repeat(km, H, axis=0))
    return lambda a, b, c: flash_attention_block(
        a, b, c, offset=offset, key_mask=kmj, interpret=True)


def _t(a, grad=False):
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x.requires_grad_() if grad else x


def _assert_lse(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert (got[~fin] == -np.inf).all() and (want[~fin] == -np.inf).all()
    if fin.any():
        assert np.abs(got[fin] - want[fin]).max() <= TOL


# (Tq, Tk, offset): every class of the visibility offset
OFFSETS = [(128, 128, 0), (128, 128, 128), (128, 128, 10 ** 6),
           (128, 128, 37), (128, 128, -37), (128, 128, -128),
           (128, 128, -10 ** 6), (128, 256, 128), (128, 256, -64),
           (256, 128, 0), (256, 128, -200), (256, 128, 300)]


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("tq,tk,offset", OFFSETS)
def test_block_plain_matches_the_pallas_kernel(tq, tk, offset, masked):
    q, k, v, km = _case(tq + tk + offset % 97, tq, tk, masked,
                        all_masked_row=masked)
    jo, jl = _jax_block(q, k, v, km, offset)(_fold(q), _fold(k), _fold(v))
    before = pf.flash_attention_block_plain.launches
    o, lse = pf.flash_attention_block(
        _t(q), _t(k), _t(v), offset=offset,
        key_mask=None if km is None else _t(km))
    assert pf.flash_attention_block_plain.launches == before + 1
    assert o.dtype == torch.float32 and tuple(lse.shape) == (N, H, tq)
    np.testing.assert_allclose(o.numpy(), _unfold(jo, tq), rtol=0, atol=TOL)
    _assert_lse(lse.numpy(), np.asarray(jl).reshape(N, H, tq))
    if offset <= -tq:
        assert (o.numpy() == 0).all() and (lse.numpy() == -np.inf).all()
    if masked:  # batch row 1 has every key masked
        assert (o.numpy()[1] == 0).all()
        assert (lse.numpy()[1] == -np.inf).all()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("t", [128, 100, 7])
def test_masked_attention_matches_dense_masked(t, causal):
    from deeplearning4j_tpu.ops.pallas_attention import _dense_masked

    q, k, v, km = _case(t, t, t, True, all_masked_row=True)
    want = np.asarray(_dense_masked(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(km),
                                    causal=causal))
    before = pf.flash_attention_block_plain.launches
    got = pf.flash_attention_masked(_t(q), _t(k), _t(v), _t(km),
                                    causal=causal)
    assert pf.flash_attention_block_plain.launches == before + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert (got.numpy()[1] == 0).all()  # batch row 1: every key masked


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("tq,tk,offset", [(128, 128, 0), (128, 256, 128),
                                          (256, 128, -64), (128, 128, -128),
                                          (128, 128, 10 ** 6)])
def test_block_fn_gradients_match_jax_vjp(tq, tk, offset, masked):
    q, k, v, km = _case(7 * tq + tk, tq, tk, masked, all_masked_row=masked)
    rng = np.random.default_rng(tq + 3 * tk)
    g = rng.standard_normal((N, tq, H, D)).astype(np.float32)
    g_lse = rng.standard_normal((N, H, tq)).astype(np.float32)
    _, vjp = jax.vjp(_jax_block(q, k, v, km, offset), _fold(q), _fold(k),
                     _fold(v))
    jdq, jdk, jdv = vjp((_fold(g), jnp.asarray(g_lse.reshape(N * H, tq))))
    tq_, tk_, tv_ = _t(q, True), _t(k, True), _t(v, True)
    o, lse = pf.FlashBlockFn.apply(tq_, tk_, tv_,
                                   None if km is None else _t(km), offset)
    torch.autograd.backward([o, lse], [_t(g), _t(g_lse)])
    for got, want, t in ((tq_.grad, jdq, tq), (tk_.grad, jdk, tk),
                         (tv_.grad, jdv, tk)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), _unfold(want, t), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_fn_gradients_match_jax_vjp(causal):
    from deeplearning4j_tpu.ops.pallas_attention import flash_attention

    q, k, v, _ = _case(3, 128, 128, False)
    g = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    jo, vjp = jax.vjp(lambda a, b, c: flash_attention(
        a, b, c, causal=causal, interpret=True), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    ts = [_t(a, True) for a in (q, k, v)]
    o = pf.FlashFn.apply(*ts, causal)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0,
                               atol=TOL)
    o.backward(_t(g))
    for got, w in zip(ts, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_blocked_backwards_equal_dense_autograd_in_f64(causal):
    """Ragged T (several key tiles and a short last one), f64: the blocked
    backwards of FlashFn and FlashBlockFn (with a mask) against autograd
    through the dense plain versions."""
    t = 300
    q, k, v, km = _case(9, t, t, True)
    g = np.random.default_rng(5).standard_normal(q.shape)
    d64 = lambda a: _t(a.astype(np.float64), True)
    for masked in (False, True):
        mask = _t(km) if masked else None
        a, b = [d64(x) for x in (q, k, v)], [d64(x) for x in (q, k, v)]
        if masked:
            out = pf.flash_attention_masked(*a, mask, causal=causal)
            ref = pf.flash_attention_block_plain(
                *b, offset=0 if causal else t, key_mask=mask)[0]
        else:
            out = pf.FlashFn.apply(*a, causal)
            ref = pf.flash_attention_plain(*b, causal=causal)[0]
        assert out.dtype == torch.float64
        out.backward(_t(g))
        ref.backward(_t(g))
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                                       rtol=0, atol=1e-10)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_attention_auto_dispatch(masked):
    from deeplearning4j_tpu.ops.pallas_attention import attention_auto

    q, k, v, km = _case(6, 96, 96, masked)
    want = np.asarray(attention_auto(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        key_mask=None if km is None else jnp.asarray(km)))
    counts = lambda: (pf.flash_attention_block_plain.launches,
                      pf.flash_attention_plain.launches)
    before = counts()
    got = pf.attention_auto(_t(q), _t(k), _t(v), causal=True,
                            key_mask=None if km is None else _t(km))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert counts() == ((before[0] + 1, before[1]) if masked
                        else (before[0], before[1] + 1))


def test_key_bias():
    km = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 0.0]])
    kb = pf.key_bias(km)
    assert kb.dtype == torch.float32
    assert kb.tolist() == [[0.0, -np.inf, 0.0], [-np.inf] * 3]
    assert torch.equal(pf.key_bias(km.bool(), torch.float64),
                       kb.double())
