"""The port's BERT encoder against the JAX package, on the CPU.

A small encoder (vocab 40, d_model 16, 2 layers, 2 heads, d_ff 32,
max_len 12, [MASK] 39), the JAX package's init handed over through numpy,
batches of token ids made from a numpy seed with padded tails.

  * f64 parity at 1e-10 (the JAX BERT has no f32 casts in its forward or
    its MLM loss, so f64 params run it in f64 as they are): ``encode``
    with padding, an all-pad sequence (the JAX -1e9 fill gives the mean of
    V; the port puts that back on K5's zero rows), ``mlm_loss`` and its
    gradients, ``classify_logits``; one MLM step's loss and moments (the
    params too: lr scales the f32 bias correction's ulp below the bar),
    and after three steps loss, params and moments at 1e-5 (both packages
    compute Adam's bias correction in f32 with their own ``pow``, as
    ``tests/test_torch_transformer_train.py`` holds the LM). The fine-tune
    step at ``encoder_lr_scale`` 1, 0.5 and 0 likewise, with the JAX
    step's f32 log-softmax cast lifted to f64 (the port's is "at least
    f32"); at 0 the encoder is bit-equal to where it started.
  * ``mask_tokens`` bit-equal to the JAX one for the same
    ``np.random.Generator`` (the 80/10/10 draws, the at-least-one rule,
    random ids skipping pad); ``BertMLM.fit`` on a JAX-written zip draws
    the JAX model's masks in its order: losses within 1e-4 relative in
    f32 over three fits.
  * Port against port: ``fit_batches`` takes the same steps as sequential
    ``fit`` calls (bit-equal params); the remat rungs give a bit-equal
    forward and gradients within 1e-10 of no remat in f64.
  * bf16 loss scaling (``DL4J_TPU_BF16``) in the MLM and the fine-tune
    step: clean steps move the scale as the JAX state does, and a step
    with an inf in an embedding row is skipped (scale halved, t and the
    params kept) in both packages.
  * Zips both ways for ``BertMLM`` and ``BertClassifier`` (params and
    optimizer state bit-equal, ``n_classes`` and ``encoder_lr_scale``
    kept), with the JAX ``ModelSerializer.restore`` dispatching the
    port's zips.
"""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.models import bert as pb  # noqa: E402
from deeplearning4j_tpu_torch.ops import (  # noqa: E402
    flash_attention as pflash,
)

CFG_KW = dict(vocab_size=40, d_model=16, n_layers=2, n_heads=2, d_ff=32,
              max_len=12, mask_token_id=39, learning_rate=1e-3, seed=2)
N, T = 4, 12
TOL_F64, TOL_ADAM, TOL_F32 = 1e-10, 1e-5, 1e-4


def _jb():
    from deeplearning4j_tpu.models import bert as jb

    return jb


def _cfgs(**kw):
    return _jb().BertConfig(**CFG_KW, **kw), pb.BertConfig(**CFG_KW, **kw)


def _tree(dtype=np.float64):
    jb = _jb()
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                  jb.init_params(jb.BertConfig(**CFG_KW)))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _tokens(seed, n=N, t=T, all_pad_row=None):
    """Ids in 1..37 (no pad, no [MASK]) with padded tails of random
    length; ``all_pad_row`` is all pad."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFG_KW["vocab_size"] - 2, (n, t))
    for i in range(n):
        ids[i, rng.integers(t // 2, t + 1):] = 0
    if all_pad_row is not None:
        ids[all_pad_row] = 0
    return ids


def _flat(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flat(v, f"{prefix}{k}.")
        else:
            a = v.detach().cpu().numpy() if torch.is_tensor(v) else v
            out.append((prefix + k, np.asarray(a)))
    return out


def _max_diff(a_tree, b_tree):
    fa, fb = _flat(a_tree), _flat(b_tree)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    return max(float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())
               for (_, a), (_, b) in zip(fa, fb))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the encoder and the losses (f64)
# ---------------------------------------------------------------------------


class TestEncoderAgainstJax:
    def test_encode_with_padding_f64(self):
        jcfg, pcfg = _cfgs()
        tree = _tree()
        ids = _tokens(0)
        assert (ids == 0).any() and (ids != 0).any()
        want = np.asarray(_jb().encode(_to_jax(tree), jnp.asarray(ids), jcfg))
        got = pb.encode(_to_port(tree), torch.from_numpy(ids), pcfg)
        assert got.dtype == torch.float64
        assert np.abs(got.numpy() - want).max() <= TOL_F64

    def test_all_pad_sequence_gets_the_mean_of_v_f64(self):
        """JAX fills masked scores with -1e9, so a sequence of pads
        attends uniformly; K5's plain version gives 0 on such rows and the
        port puts the mean of V back: ``encode`` and the attention itself
        agree with JAX, gradients included."""
        jb = _jb()
        jcfg, pcfg = _cfgs()
        tree = _tree()
        ids = _tokens(1, all_pad_row=2)
        want = np.asarray(jb.encode(_to_jax(tree), jnp.asarray(ids), jcfg))
        got = pb.encode(_to_port(tree), torch.from_numpy(ids), pcfg).numpy()
        assert np.abs(got - want).max() <= TOL_F64
        rng = np.random.default_rng(3)
        q, k, v, g = (rng.standard_normal((N, T, 16)) for _ in range(4))
        km = ids != 0
        jo, vjp = jax.vjp(lambda a, b, c: jb._bi_attention(a, b, c, 2,
                                                           jnp.asarray(km)),
                          jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        po = pb._bi_attention(*leaves, 2, torch.from_numpy(km))
        np.testing.assert_allclose(po.detach().numpy()[2],
                                   np.broadcast_to(v[2].mean(0), (T, 16)),
                                   rtol=0, atol=TOL_F64)
        assert np.abs(po.detach().numpy() - np.asarray(jo)).max() <= TOL_F64
        pg = torch.autograd.grad(po, leaves, torch.from_numpy(g))
        for a, b in zip(pg, vjp(jnp.asarray(g))):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL_F64
        assert (pg[0][2] == 0).all() and (pg[1][2] == 0).all()

    def test_mlm_loss_and_gradients_f64(self):
        jb = _jb()
        jcfg, pcfg = _cfgs()
        tree = _tree()
        x, y, w = jb.mask_tokens(_tokens(4), jcfg, np.random.default_rng(4))
        jl, jg = jax.value_and_grad(jb.mlm_loss)(
            _to_jax(tree), jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
            jcfg)
        pl, pg = pb.value_and_grad(lambda p: pb.mlm_loss(
            p, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
            pcfg), _to_port(tree))
        assert abs(float(jl) - float(pl)) <= TOL_F64
        assert _max_diff(pg, _np(jg)) <= TOL_F64

    def test_classify_logits_f64(self):
        jb = _jb()
        jcfg, pcfg = _cfgs()
        tree = _tree()
        head = _np(jb.init_classifier_head(jcfg, 3, seed=5))
        head = jax.tree_util.tree_map(lambda a: a.astype(np.float64), head)
        ids = _tokens(6, all_pad_row=1)
        want = np.asarray(jb.classify_logits(_to_jax(tree), _to_jax(head),
                                             jnp.asarray(ids), jcfg))
        got = pb.classify_logits(_to_port(tree), _to_port(head),
                                 torch.from_numpy(ids), pcfg).numpy()
        assert got.shape == (N, 3)
        assert np.abs(got - want).max() <= TOL_F64

    @pytest.mark.parametrize("seed,n,t", [(0, 4, 12), (1, 2, 3), (7, 1, 1),
                                          (9, 16, 12)])
    def test_mask_tokens_bit_equal(self, seed, n, t):
        """The same draws from the same generator, on batches large enough
        for every branch (80/10/10) and tiny enough for the at-least-one
        rule."""
        jcfg, pcfg = _cfgs()
        ids = _tokens(seed, n, t)
        ids[0, 0] = 5  # at least one selectable position
        jr, pr = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):
            want = _jb().mask_tokens(ids, jcfg, jr)
            got = pb.mask_tokens(ids, pcfg, pr)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        assert jr.random() == pr.random()


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------


def _jax_f32_as_f64(fn):
    """``fn`` (a JAX bert function) run with ``jnp.float32`` meaning f64:
    the fine-tune loss's f32 cast lifted for the gradient check."""
    jb = _jb()
    proxy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                     if not n.startswith("_")})
    proxy.float32 = jnp.float64
    return types.FunctionType(fn.__code__, dict(vars(jb), jnp=proxy),
                              fn.__name__, fn.__defaults__, fn.__closure__)


class TestStepsAgainstJax:
    def test_three_mlm_steps_f64(self):
        jb = _jb()
        jcfg, pcfg = _cfgs()
        tree = _tree()
        jp, pp = _to_jax(tree), _to_port(tree)
        jo, po = jb.init_opt_state(jp), pb.init_opt_state(pp)
        jstep, pstep = jb.make_train_step(jcfg), pb.make_train_step(pcfg)
        for i in range(3):
            x, y, w = jb.mask_tokens(_tokens(10 + i), jcfg,
                                     np.random.default_rng(i))
            jp, jo, jl = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(w))
            pp, po, pl = pstep(pp, po, torch.from_numpy(x),
                               torch.from_numpy(y), torch.from_numpy(w))
            tol = TOL_F64 if i == 0 else TOL_ADAM
            assert abs(float(jl) - float(pl)) <= tol
            if i == 0:
                for key in ("m", "v"):
                    assert _max_diff(po[key], _np(jo[key])) <= TOL_F64
                assert _max_diff(pp, _np(jp)) <= TOL_F64
        jo = _np(jo)
        assert int(po["t"]) == int(jo["t"]) == 3
        assert _max_diff(pp, _np(jp)) <= TOL_ADAM
        for key in ("m", "v"):
            assert _max_diff(po[key], jo[key]) <= TOL_ADAM

    @pytest.mark.parametrize("scale", [1.0, 0.5, 0.0])
    def test_finetune_step_f64(self, scale):
        jb = _jb()
        jcfg, pcfg = _cfgs(weight_decay=0.1)
        tree = _tree()
        head = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            jb.init_classifier_head(jcfg, 2, seed=3))
        both = {"encoder": tree, "head": head}
        jp, pp = _to_jax(both), _to_port(both)
        jo, po = jb.init_opt_state(jp), pb.init_opt_state(pp)
        jstep = _jax_f32_as_f64(jb.make_finetune_step)(jcfg, 2, scale)
        pstep = pb.make_finetune_step(pcfg, 2, scale)
        rng = np.random.default_rng(11)
        for i in range(3):
            ids = _tokens(20 + i, all_pad_row=3 if i == 1 else None)
            labels = rng.integers(0, 2, N)
            jp, jo, jl = jstep(jp, jo, jnp.asarray(ids), jnp.asarray(labels))
            pp, po, pl = pstep(pp, po, torch.from_numpy(ids),
                               torch.from_numpy(labels))
            tol = TOL_F64 if i == 0 else TOL_ADAM
            assert abs(float(jl) - float(pl)) <= tol
            if i == 0:
                assert _max_diff(pp, _np(jp)) <= TOL_F64
        assert _max_diff(pp, _np(jp)) <= TOL_ADAM
        for key in ("m", "v"):
            assert _max_diff(po[key], _np(jo[key])) <= TOL_ADAM
        if scale == 0.0:
            for (_, a), (_, b) in zip(_flat(pp["encoder"]), _flat(tree)):
                assert np.array_equal(a, b)
            assert _max_diff(pp["head"], head) > 0

    def test_fit_draws_the_jax_masks_in_order(self, tmp_path):
        """A JAX-written zip loaded into the port: three ``fit`` calls on
        the same batches draw the same masks from ``cfg.seed``'s generator
        and give the JAX losses (f32), and ``masked_accuracy`` reads its
        own generator in both."""
        jb = _jb()
        jcfg, _ = _cfgs()
        jm = jb.BertMLM(jcfg)
        path = str(tmp_path / "jax_mlm.zip")
        jm.save(path)
        pm = pb.BertMLM.load(path, device="cpu")
        assert _max_diff(pb.params_from_numpy(_np(jm.params), device="cpu"),
                         pm.params) == 0.0
        for i in range(3):
            ids = _tokens(30 + i)
            jl, pl = jm.fit(ids), pm.fit(ids)
            assert abs(jl - pl) <= TOL_F32 * abs(jl)
        assert jm._rng.random() == pm._rng.random()
        ids = _tokens(40, n=8)
        assert pm.masked_accuracy(ids) == pytest.approx(
            jm.masked_accuracy(ids), abs=1e-9)

    def test_fit_batches_equals_sequential_fits(self):
        pcfg = pb.BertConfig(**CFG_KW)
        a = pb.BertMLM(pcfg, device="cpu")
        b = pb.BertMLM(pcfg, device="cpu")
        stack = np.stack([_tokens(50 + i) for i in range(3)])
        losses = [a.fit(x) for x in stack]
        last = b.fit_batches(stack)
        assert last == losses[-1]
        for (_, x), (_, y) in zip(_flat(a.params), _flat(b.params)):
            assert np.array_equal(x, y)
        assert int(a.opt["t"]) == int(b.opt["t"]) == 3
        assert a._rng.random() == b._rng.random()
        with pytest.raises(ValueError, match="stacked"):
            b.fit_batches(stack[0])

    @pytest.mark.parametrize("policy", ["dots", "block"])
    def test_remat_rungs_give_the_same_gradients_f64(self, policy):
        pcfg = pb.BertConfig(**dict(CFG_KW, remat="none"))
        tree = _tree()
        x, y, w = pb.mask_tokens(_tokens(60, all_pad_row=0), pcfg,
                                 np.random.default_rng(60))
        args = [torch.from_numpy(a) for a in (x, y, w)]
        out = {}
        for name, c in (("none", pcfg),
                        (policy, pb.BertConfig(**dict(CFG_KW,
                                                      remat=policy)))):
            before = pflash.flash_attention_block_plain.launches
            out[name] = pb.value_and_grad(
                lambda p: pb.mlm_loss(p, *args, c), _to_port(tree)) + (
                pflash.flash_attention_block_plain.launches - before,)
        assert float(out[policy][0]) == float(out["none"][0])
        assert _max_diff(out[policy][1], out["none"][1]) <= TOL_F64
        # K5's plain version once per layer forward; the rungs rerun it
        assert out["none"][2] == CFG_KW["n_layers"]
        assert out[policy][2] == 2 * CFG_KW["n_layers"]


def _scale_state(opt):
    return (float(opt["loss_scale"]), int(opt["ls_good"]),
            int(opt["ls_skipped"]))


class TestLossScaling:
    def test_mlm_and_finetune_steps_follow_jax(self, monkeypatch):
        """Three clean steps at growth 2 (one doubling), then a step with
        an inf in an embedding row: skipped (scale halved, t and the
        params kept) in both packages; the same for the fine-tune step."""
        jb = _jb()
        monkeypatch.setenv("DL4J_TPU_BF16", "1")
        monkeypatch.setenv("DL4J_TPU_LOSS_SCALE", "8:2")
        jcfg, pcfg = _cfgs()
        tree = _tree(np.float32)
        head = _np(jb.init_classifier_head(jcfg, 2, seed=1))
        ids = [_tokens(70 + i) for i in range(4)]
        labels = np.array([0, 1, 1, 0])
        for kind in ("mlm", "finetune"):
            if kind == "mlm":
                start = tree
                jstep, pstep = jb.make_train_step(jcfg), \
                    pb.make_train_step(pcfg)
                batch = lambda i: jb.mask_tokens(ids[i], jcfg,
                                                 np.random.default_rng(i))
            else:
                start = {"encoder": tree, "head": head}
                jstep = jb.make_finetune_step(jcfg, 2)
                pstep = pb.make_finetune_step(pcfg, 2)
                batch = lambda i: (ids[i], labels)
            assert pstep.loss_scaled
            jp, pp = _to_jax(start), _to_port(start)
            jo, po = jb.init_opt_state(jp), pb.init_opt_state(pp, True)
            assert set(po) == set(jo)
            for i in range(3):
                xs = batch(i)
                jp, jo, jl = jstep(jp, jo, *map(jnp.asarray, xs))
                pp, po, pl = pstep(pp, po, *map(torch.from_numpy, xs))
                assert _scale_state(po) == _scale_state(jo)
                assert abs(float(jl) - float(pl)) <= 1e-2 * abs(float(jl))
            assert _scale_state(po) == (16.0, 1, 0)
            poisoned = _np(jp)
            enc = poisoned if kind == "mlm" else poisoned["encoder"]
            enc["embed"] = enc["embed"].copy()
            enc["embed"][ids[3][0, 0], 0] = np.inf
            jp, pp = _to_jax(poisoned), _to_port(poisoned)
            jp2, jo2, _ = jstep(jp, jo, *map(jnp.asarray, batch(3)))
            pp2, po2, _ = pstep(pp, po, *map(torch.from_numpy, batch(3)))
            assert _scale_state(po2) == _scale_state(jo2) == (8.0, 0, 1)
            assert int(po2["t"]) == int(jo2["t"]) == 3
            for (_, a), (_, b) in zip(_flat(pp2), _flat(pp)):
                assert np.array_equal(a, b, equal_nan=True)


# ---------------------------------------------------------------------------
# zips
# ---------------------------------------------------------------------------


class TestZips:
    def test_mlm_zip_both_ways(self, tmp_path):
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        jb = _jb()
        _, pcfg = _cfgs()
        pm = pb.BertMLM(pcfg, device="cpu")
        pm.fit(_tokens(80))
        path = str(tmp_path / "port_mlm.zip")
        pm.save(path)
        for jm in (jb.BertMLM.load(path), ModelSerializer.restore(path)):
            assert isinstance(jm, jb.BertMLM)
            assert _max_diff(pm.params, _np(jm.params)) == 0.0
            assert _max_diff(pm.opt, _np(jm.opt)) == 0.0
        jm.fit(_tokens(81))
        back = str(tmp_path / "jax_mlm.zip")
        jm.save(back)
        pm2 = pb.BertMLM.load(back, device="cpu")
        assert pm2.cfg == pcfg
        assert _max_diff(pm2.params, _np(jm.params)) == 0.0
        assert _max_diff(pm2.opt, _np(jm.opt)) == 0.0
        assert int(pm2.opt["t"]) == 2
        ids = _tokens(82)
        np.testing.assert_allclose(pm2.predict_logits(ids),
                                   jm.predict_logits(ids), rtol=0,
                                   atol=TOL_F32)
        np.testing.assert_allclose(pm2.embed_tokens(ids),
                                   jm.embed_tokens(ids), rtol=0,
                                   atol=TOL_F32)

    def test_classifier_zip_both_ways(self, tmp_path):
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        jb = _jb()
        _, pcfg = _cfgs()
        clf = pb.BertClassifier(pb.BertMLM(pcfg, device="cpu"), 3,
                                encoder_lr_scale=0.25)
        ids, labels = _tokens(90), np.array([0, 2, 1, 2])
        clf.fit(ids, labels)
        path = str(tmp_path / "port_clf.zip")
        clf.save(path)
        jc = ModelSerializer.restore(path)
        assert isinstance(jc, jb.BertClassifier)
        assert jc.n_classes == 3 and jc._encoder_lr_scale == 0.25
        assert _max_diff(clf.state, _np(jc.state)) == 0.0
        assert _max_diff(clf.opt, _np(jc.opt)) == 0.0
        jc.fit(ids, labels)
        back = str(tmp_path / "jax_clf.zip")
        jc.save(back)
        clf2 = pb.BertClassifier.load(back, device="cpu")
        assert clf2.n_classes == 3 and clf2._encoder_lr_scale == 0.25
        assert _max_diff(clf2.state, _np(jc.state)) == 0.0
        assert _max_diff(clf2.opt, _np(jc.opt)) == 0.0
        np.testing.assert_array_equal(clf2.predict(ids), jc.predict(ids))
        assert clf2.accuracy(ids, labels) == jc.accuracy(ids, labels)
