"""The port's TransformerLM sampling against the JAX package, on the CPU.

Small model (vocab 64, d_model 64, 2 layers, 4 heads, d_ff 128, max_len
64), f32 ``strict``, the JAX package's init handed over through numpy.

  * ``_filter_logits`` (top-k, then the nucleus; the top token always
    survives) gives the same -inf mask as the JAX function on the same
    tempered logits.
  * ``prefill_cache`` + ``decode_step`` logits equal the JAX ones at 1e-4
    abs (f32 GEMMs summed in another order) over several steps.
  * Greedy transcripts (temperature 1e-6: the Gumbel noise cannot beat a
    scaled margin) equal the JAX package's, with and without the KV
    cache and with a prompt longer than the window. Where a row splits,
    the JAX top-2 logit margin there must be below 1e-4 (a tie that f32
    summation order may break either way); that row is not compared past
    it. ``top_k=1`` equals greedy.
  * Port against port (jax.random and torch draw different bits):
    ``use_cache`` on and off give the same sampled transcript, a seed
    repeats its stream, filters restrict the support, and bad arguments
    raise as the JAX package's do.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.models import transformer as pt  # noqa: E402

CFG_KW = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, d_ff=128,
              max_len=64, seed=2)
TOL = 1e-4
TIE = 1e-4
GREEDY = 1e-6


@pytest.fixture(scope="module")
def pair():
    from deeplearning4j_tpu.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    jlm = TransformerLM(TransformerConfig(**CFG_KW))
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    plm = pt.TransformerLM(pt.TransformerConfig(**CFG_KW), device="cpu",
                           params=pt.params_from_numpy(tree, device="cpu"))
    return jlm, plm


def _prompts(seed, n=3, t=9):
    return np.random.default_rng(seed).integers(
        0, CFG_KW["vocab_size"], (n, t)).astype(np.int32)


@pytest.mark.parametrize("top_k,top_p", [(None, 0.9), (5, None), (5, 0.5),
                                         (1, None), (None, 1.0),
                                         (64, 0.05)])
def test_filter_logits_masks_match_jax(pair, top_k, top_p):
    jlm, plm = pair
    rng = np.random.default_rng(top_k or 0)
    logits = (rng.standard_normal((6, 64)) * 3).astype(np.float32)
    want = np.asarray(jlm._filter_logits(
        jnp.asarray(logits), top_k,
        None if top_p is None else jnp.asarray(top_p, jnp.float32)))
    got = plm._filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  logits[np.isfinite(want)])
    assert np.isfinite(got.max(axis=-1)).all()  # the top token survives


def test_decode_step_logits_match_jax(pair):
    from deeplearning4j_tpu.models.transformer import (
        decode_step,
        prefill_cache,
    )

    jlm, plm = pair
    prompt = _prompts(1, t=40)  # right-padded window, prompt of 12
    prompt[:, 12:] = 0
    jc, _ = prefill_cache(jlm.params, jnp.asarray(prompt), jlm.cfg)
    with torch.inference_mode():
        pc, _ = pt.prefill_cache(plm.compute_params,
                                 torch.from_numpy(prompt).long(), plm.cfg)
    tok = prompt[:, 11]
    for pos in range(11, 16):
        jc, jl = decode_step(jlm.params, jc, jnp.asarray(tok), pos, jlm.cfg)
        with torch.inference_mode():
            pc, pl = pt.decode_step(plm.compute_params, pc,
                                    torch.from_numpy(tok), pos, plm.cfg)
        jl = np.asarray(jl)
        assert pl.dtype == torch.float32
        assert np.abs(pl.numpy() - jl).max() <= TOL
        tok = jl.argmax(-1).astype(np.int32)
    np.testing.assert_allclose(pc["k"].numpy(), np.asarray(jc["k"]),
                               atol=TOL, rtol=0)


def _assert_transcripts(jlm, prompt, n_new, want, got):
    """Equal rows, or a split where the JAX top-2 margin is a tie."""
    from deeplearning4j_tpu.models.transformer import forward

    keep = min(prompt.shape[1], CFG_KW["max_len"] - n_new)
    equal = 0
    for row, (jt, ptk) in enumerate(zip(want, got)):
        diff = np.nonzero(jt != ptk)[0]
        if diff.size == 0:
            equal += 1
            continue
        j = int(diff[0])
        ctx = np.concatenate([prompt[row, prompt.shape[1] - keep:],
                              jt[:j]]).astype(np.int32)[None]
        logits = np.asarray(forward(jlm.params, jnp.asarray(ctx),
                                    jlm.cfg)[0])[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < TIE, (
            f"row {row} split at token {j} with a JAX margin of "
            f"{top2[1] - top2[0]:.3g}: not a tie")
    return equal


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("t,n_new", [(9, 12), (70, 10)])
def test_greedy_transcripts_match_jax(pair, use_cache, t, n_new):
    jlm, plm = pair
    prompt = _prompts(t, t=t)
    want = np.asarray(jlm.generate(jnp.asarray(prompt), n_new,
                                   temperature=GREEDY, use_cache=use_cache))
    got = plm.generate(prompt, n_new, temperature=GREEDY,
                       use_cache=use_cache)
    assert got.shape == (3, n_new) and got.dtype == torch.int64
    assert _assert_transcripts(jlm, prompt, n_new, want, got.numpy()) >= 2


def test_top_k_1_equals_greedy(pair):
    _, plm = pair
    prompt = _prompts(4)
    greedy = plm.generate(prompt, 10, temperature=GREEDY)
    for seed in (0, 1):
        assert torch.equal(plm.generate(prompt, 10, temperature=1.5,
                                        seed=seed, top_k=1), greedy)


@pytest.mark.parametrize("top_k,top_p", [(None, None), (8, None),
                                         (None, 0.8), (6, 0.7)])
def test_use_cache_on_and_off_give_the_same_transcript(pair, top_k, top_p):
    _, plm = pair
    prompt = _prompts(5)
    kw = dict(temperature=0.9, seed=3, top_k=top_k, top_p=top_p)
    assert torch.equal(plm.generate(prompt, 12, use_cache=True, **kw),
                       plm.generate(prompt, 12, use_cache=False, **kw))


def test_a_seed_repeats_its_stream(pair):
    _, plm = pair
    prompt = _prompts(6)
    a = plm.generate(prompt, 16, temperature=1.0, seed=7, top_p=0.95)
    assert torch.equal(a, plm.generate(prompt, 16, temperature=1.0, seed=7,
                                       top_p=0.95))
    assert not torch.equal(a, plm.generate(prompt, 16, temperature=1.0,
                                           seed=8, top_p=0.95))


def test_top_k_restricts_the_support(pair):
    """Every sampled token is among the k most likely at its step."""
    _, plm = pair
    prompt = _prompts(7, n=4)
    out = plm.generate(prompt, 6, temperature=5.0, seed=1, top_k=3,
                       use_cache=False)
    for step in range(6):
        ctx = np.concatenate([prompt, out[:, :step].numpy()], axis=1)
        logits = plm.logits(ctx)[:, -1]
        top = torch.topk(logits, 3, dim=-1).indices
        assert (top == out[:, step:step + 1]).any(dim=-1).all()


@pytest.mark.parametrize("kw,msg", [
    (dict(n_new=64), "must be < max_len"),
    (dict(n_new=4, top_k=0), "top_k 0 must be in"),
    (dict(n_new=4, top_k=65), "top_k 65 must be in"),
    (dict(n_new=4, top_p=0.0), "top_p 0.0 must be in"),
    (dict(n_new=4, top_p=1.5), "top_p 1.5 must be in"),
])
def test_bad_arguments_raise_as_in_jax(pair, kw, msg):
    jlm, plm = pair
    prompt = _prompts(8)
    with pytest.raises(ValueError, match=msg):
        jlm.generate(jnp.asarray(prompt), **kw)
    with pytest.raises(ValueError, match=msg):
        plm.generate(prompt, **kw)
