"""The port's TransformerLM training against the JAX package, on the CPU.

Small model (vocab 64, d_model 64, 2 layers, 4 heads, d_ff 128, max_len
64), the JAX package's init handed over through numpy, batches of token
ids made from a numpy seed.

  * Step parity in f64 (the JAX package's gradient-check mode): both
    forwards run in f64 — the JAX ``forward``'s f32 casts lifted to f64 by
    running its code with ``float32`` meaning ``float64``, both configs'
    compute dtype set to f64 — so loss and gradients agree at 1e-10
    (``use_flash`` on and off in the port: the plain K4 and K7 through
    ``FlashFn``; the JAX package's dense attention). After one Adam step
    the moments and the params agree at 1e-10; after three, loss, params
    and moments at 1e-5: both packages compute Adam's bias correction in
    f32 with their own ``pow`` (as ``tests/test_torch_training.py`` holds
    Adam). Under ``strict`` and
    under ``clip_grad_norm`` plus ``weight_decay``. ``accum_steps=2``
    against the JAX accumulation in f32 (its scan carries an f32 loss and
    refuses f64) at 1e-5; in f64 the port's mean of microbatch means
    equals its full-batch step at 1e-10.
  * Port against port: the multi step is bit-equal to K single steps; the
    warmup + cosine learning rate equals the JAX ``_scheduled_lr`` at
    every t (bit-equal in the warmup, 1e-6 relative under the cosine,
    which XLA's f32 ``cos`` rounds a few ulp off); remat ``none``,
    ``dots`` and ``block`` give a bit-equal forward and gradients within
    1e-10 of no remat in f64 (``dots`` keeps K4's
    output: its plain version runs once per layer, ``block`` twice).
  * bf16 loss scaling (``DL4J_TPU_BF16``): the scale state (growth after N
    clean steps, halve-and-skip on a non-finite gradient, the step count
    kept on a skip) follows the JAX state step for step; the helpers
    agree on the same gradients.
  * Model surface: ``fit_iterator`` with listeners, the iteration carried
    across calls (losses within 1e-4 of the JAX package's in f32);
    ``evaluate`` on a masked iterator within 1e-5; zips both ways (params
    and optimizer state bit-equal, iteration = t); ``fit`` runs attention
    through ``FlashFn`` on the CPU (the plain K4 and K7 once per layer).
"""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator  # noqa: E402
from deeplearning4j_tpu_torch.models import transformer as pt  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as pflash  # noqa: E402
from deeplearning4j_tpu_torch.ops import lowprec as plow  # noqa: E402
from deeplearning4j_tpu_torch.ops import remat as premat  # noqa: E402
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: E402
    CollectScoresIterationListener,
)

CFG_KW = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, d_ff=128,
              max_len=64, learning_rate=1e-3, seed=3)
N, T = 4, 32
TOL_F64 = 1e-10
TOL_ADAM = 1e-5
TOL_F32 = 1e-4


def _jtr():
    from deeplearning4j_tpu.models import transformer as jtr

    return jtr


def _cfgs(**kw):
    jtr = _jtr()
    return (jtr.TransformerConfig(**CFG_KW, **kw),
            pt.TransformerConfig(**CFG_KW, **kw))


def _jax_params(dtype=np.float32):
    jtr = _jtr()
    tree = jtr.init_params(jtr.TransformerConfig(**CFG_KW))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_port(tree):
    """A numpy tree as port tensors, dtype kept."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _batch(seed, n=N, t=T, k=None):
    rng = np.random.default_rng(seed)
    shape = (n, t + 1) if k is None else (k, n, t + 1)
    ids = rng.integers(0, CFG_KW["vocab_size"], shape)
    return ids[..., :-1].astype(np.int32), ids[..., 1:].astype(np.int32)


def _flat(tree, prefix=""):
    """(path, numpy array) of every leaf, sorted by path."""
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


@pytest.fixture
def f64(monkeypatch):
    """Both forwards in f64: the JAX ``forward`` run with ``float32``
    meaning ``float64`` (its final-LN and logits casts), both configs'
    compute dtype f64. Everything else of the JAX step (the schedule,
    Adam's bias correction) keeps its f32."""
    jtr = _jtr()
    proxy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                     if not n.startswith("_")})
    proxy.float32 = jnp.float64
    fwd = types.FunctionType(jtr.forward.__code__,
                             dict(jtr.__dict__, jnp=proxy), "forward",
                             jtr.forward.__defaults__,
                             jtr.forward.__closure__)
    monkeypatch.setattr(jtr, "forward", fwd)
    monkeypatch.setattr(jtr.TransformerConfig, "compute_dtype",
                        property(lambda self: jnp.float64))
    monkeypatch.setattr(pt.TransformerConfig, "compute_dtype",
                        property(lambda self: torch.float64))


# ---------------------------------------------------------------------------
# step parity (f64)
# ---------------------------------------------------------------------------


class TestStepAgainstJax:
    @pytest.mark.parametrize("use_flash", [True, False])
    @pytest.mark.parametrize("extra", [{}, {"clip_grad_norm": 0.5,
                                            "weight_decay": 0.1}],
                             ids=["strict", "clip_wd"])
    def test_step_f64(self, f64, extra, use_flash):
        jtr = _jtr()
        jcfg, pcfg = _cfgs(**extra)
        pcfg = pt.dataclasses.replace(pcfg, use_flash=use_flash)
        tree = _jax_params(np.float64)
        x, y = _batch(0)
        jl, jg = jax.value_and_grad(jtr.loss_fn)(_to_jax(tree), jnp.asarray(x),
                                                 jnp.asarray(y), jcfg)
        pl, pg = pt.value_and_grad(
            lambda p: pt.loss_fn(p, torch.from_numpy(x), torch.from_numpy(y),
                                 pcfg), _to_port(tree))
        assert abs(float(jl) - float(pl)) <= TOL_F64
        assert _max_diff(pg, jax.tree_util.tree_map(np.asarray, jg)) \
            <= TOL_F64
        jp, jo = _to_jax(tree), jtr.init_opt_state(_to_jax(tree))
        pp = _to_port(tree)
        po = pt.init_opt_state(pp)
        jstep, pstep = jtr.make_train_step(jcfg), pt.make_train_step(pcfg)
        for seed in range(3):
            x, y = _batch(seed)
            jp, jo, jl = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y))
            pp, po, pl = pstep(pp, po, torch.from_numpy(x),
                               torch.from_numpy(y))
            assert abs(float(jl) - float(pl)) <= TOL_ADAM
        jo = jax.tree_util.tree_map(np.asarray, jo)
        assert int(po["t"]) == int(jo["t"]) == 3
        assert po["t"].dtype == torch.int32
        assert _max_diff(pp, jax.tree_util.tree_map(np.asarray, jp)) \
            <= TOL_ADAM
        for key in ("m", "v"):
            assert _max_diff(po[key], jo[key]) <= TOL_ADAM

    def test_first_step_f64_at_1e10(self, f64):
        """One step from fresh state: the moments at 1e-10 (they see only
        the gradients), the params at 1e-10 (the f32 bias corrections of
        step 1 agree to an ulp, lr 1e-3 scales it below the bar)."""
        jtr = _jtr()
        jcfg, pcfg = _cfgs()
        tree = _jax_params(np.float64)
        x, y = _batch(5)
        jp, jo, jl = jtr.make_train_step(jcfg)(
            _to_jax(tree), jtr.init_opt_state(_to_jax(tree)),
            jnp.asarray(x), jnp.asarray(y))
        pp = _to_port(tree)
        pp, po, pl = pt.make_train_step(pcfg)(
            pp, pt.init_opt_state(pp), torch.from_numpy(x),
            torch.from_numpy(y))
        assert abs(float(jl) - float(pl)) <= TOL_F64
        jo = jax.tree_util.tree_map(np.asarray, jo)
        assert _max_diff(po["m"], jo["m"]) <= TOL_F64
        assert _max_diff(po["v"], jo["v"]) <= TOL_F64
        assert _max_diff(pp, jax.tree_util.tree_map(np.asarray, jp)) \
            <= TOL_F64

    def test_accum_steps_against_jax(self):
        """accum_steps=2 against the JAX accumulation, in f32 (its scan
        carries an f32 loss, so it does not run in f64): loss and params
        within 1e-5."""
        jtr = _jtr()
        jcfg, pcfg = _cfgs(accum_steps=2)
        tree = _jax_params()
        jp, jo = _to_jax(tree), jtr.init_opt_state(_to_jax(tree))
        pp = _to_port(tree)
        po = pt.init_opt_state(pp)
        jstep, pstep = jtr.make_train_step(jcfg), pt.make_train_step(pcfg)
        for seed in range(2):
            x, y = _batch(seed)
            jp, jo, jl = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y))
            pp, po, pl = pstep(pp, po, torch.from_numpy(x),
                               torch.from_numpy(y))
            assert abs(float(jl) - float(pl)) <= TOL_ADAM
        assert _max_diff(pp, jax.tree_util.tree_map(np.asarray, jp)) \
            <= TOL_ADAM

    def test_accum_mean_of_means_is_the_full_batch_f64(self, f64):
        _, pcfg = _cfgs(accum_steps=2)
        tree = _jax_params(np.float64)
        x, y = (torch.from_numpy(a) for a in _batch(1))
        pp = _to_port(tree)
        _, po, pl = pt.make_train_step(pcfg)(pp, pt.init_opt_state(pp), x, y)
        pq = _to_port(tree)
        _, qo, ql = pt.make_train_step(_cfgs()[1])(
            pq, pt.init_opt_state(pq), x, y)
        assert abs(float(ql) - float(pl)) <= TOL_F64
        assert _max_diff(qo["m"], po["m"]) <= TOL_F64

    def test_accum_not_dividing_the_batch_raises(self):
        _, pcfg = _cfgs(accum_steps=3)
        lm = pt.TransformerLM(pcfg, device="cpu")
        x, y = _batch(0)
        with pytest.raises(ValueError, match="not divisible by accum_steps"):
            lm.fit(x, y)

    def test_decay_mask_and_clip_match_jax(self):
        jtr = _jtr()
        tree = _jax_params()
        jm = jtr._decay_mask(_to_jax(tree))
        pm = pt._decay_mask(_to_port(tree))
        assert dict(_flat(pm)) == {k: bool(v) for k, v in _flat(jm)}
        rng = np.random.default_rng(3)
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape), tree)
        jc, jn = jtr._clip_by_global_norm(_to_jax(grads), 2.0)
        pc, pn = pt._clip_by_global_norm(_to_port(grads), 2.0)
        assert abs(float(jn) - float(pn)) <= 1e-12 * float(jn)
        assert _max_diff(pc, jax.tree_util.tree_map(np.asarray, jc)) <= 1e-12


class TestPortSteps:
    def test_multi_step_is_bit_equal_to_single_steps(self):
        _, pcfg = _cfgs(clip_grad_norm=1.0, weight_decay=0.01)
        tree = _jax_params()
        xs, ys = _batch(2, k=3)
        p1 = _to_port(tree)
        o1 = pt.init_opt_state(p1)
        step = pt.make_train_step(pcfg)
        losses = []
        for x, y in zip(xs, ys):
            p1, o1, loss = step(p1, o1, torch.from_numpy(x),
                                torch.from_numpy(y))
            losses.append(loss)
        p2 = _to_port(tree)
        p2, o2, l2 = pt.make_train_multi_step(pcfg)(
            p2, pt.init_opt_state(p2), torch.from_numpy(xs),
            torch.from_numpy(ys))
        assert torch.equal(torch.stack(losses), l2)
        assert _max_diff(p1, p2) == 0.0
        assert _max_diff(o1["m"], o2["m"]) == 0.0
        assert int(o1["t"]) == int(o2["t"]) == 3
        lm = pt.TransformerLM(pcfg, device="cpu", params=_to_port(tree))
        lm.fit_batches(xs, ys)
        assert lm.iteration == 3 and _max_diff(lm.params, p2) == 0.0

    def test_warmup_cosine_lr_matches_jax_at_every_t(self):
        """Within 1e-6 relative: XLA's f32 cosine on the CPU is a few ulp
        from the correctly rounded one that torch returns (t=17: 9.549147e-5
        against 9.549150e-5, exact 9.5491502e-5); the warmup steps and the
        plateau are bit-equal."""
        jtr = _jtr()
        jcfg, pcfg = _cfgs(warmup_steps=5, lr_schedule="cosine",
                           total_steps=20)
        for t in range(0, 24):
            want = float(jtr._scheduled_lr(jcfg, jnp.asarray(t, jnp.int32)))
            got = pt._scheduled_lr(pcfg, torch.tensor(t, dtype=torch.int32))
            assert got.dtype == torch.float32
            if t <= 5:
                assert float(got) == want, t
            else:
                assert abs(float(got) - want) <= 1e-6 * abs(want), t

    def test_schedule_validation_matches_jax(self):
        for kw, msg in (({"lr_schedule": "linear"}, "unknown lr_schedule"),
                        ({"lr_schedule": "cosine"}, "needs total_steps")):
            _, pcfg = _cfgs(**kw)
            with pytest.raises(ValueError, match=msg):
                pt.make_train_step(pcfg)


class TestRemat:
    def test_policy_resolution_matches_jax(self, monkeypatch):
        from deeplearning4j_tpu.ops.remat import POLICIES, remat_policy

        assert premat.POLICIES == POLICIES
        for env in ("", "dots", "block", "none"):
            monkeypatch.setenv(premat.ENV_REMAT, env)
            for configured in ("auto", None, "dots", "BLOCK", "none"):
                assert premat.remat_policy(configured) == \
                    remat_policy(configured)
        with pytest.raises(ValueError, match="unknown remat policy"):
            premat.remat_policy("sideways")

    @pytest.mark.parametrize("use_flash", [True, False])
    def test_forward_bit_equal_and_grads_within_1e10(self, f64, use_flash):
        _, pcfg = _cfgs(use_flash=use_flash)
        tree = _to_port(_jax_params(np.float64))
        x, y = (torch.from_numpy(a) for a in _batch(4))
        out = {}
        for policy in premat.POLICIES:
            cfg = pt.dataclasses.replace(pcfg, remat=policy)
            before = pflash.flash_attention_plain.launches
            with torch.enable_grad():
                live = pt.tree_map(lambda a: a.clone().requires_grad_(),
                                   tree)
                logits, _ = pt.forward(live, x, cfg)
                loss = pt.nll_loss(logits, y)
                grads = torch.autograd.grad(loss, pt.tree_leaves(live))
            out[policy] = (logits.detach(), grads,
                           pflash.flash_attention_plain.launches - before)
        ref_logits, ref_grads, _ = out["none"]
        for policy, (logits, grads, launches) in out.items():
            assert torch.equal(logits, ref_logits), policy
            for a, b in zip(grads, ref_grads):
                assert (a - b).abs().max().item() <= TOL_F64, policy
        if use_flash:  # dots keeps K4's output; block launches it again
            layers = pcfg.n_layers
            assert [out[p][2] for p in premat.POLICIES] == \
                [layers, layers, 2 * layers]

    def test_training_under_each_rung_equals_none(self, monkeypatch):
        _, pcfg = _cfgs()
        tree = _jax_params()
        xs, ys = _batch(6, k=2)
        params = {}
        for policy in premat.POLICIES:
            monkeypatch.setenv(premat.ENV_REMAT, policy)
            lm = pt.TransformerLM(pcfg, device="cpu", params=_to_port(tree))
            lm.fit_batches(xs, ys)
            params[policy] = lm.params
        for policy in ("dots", "block"):
            assert _max_diff(params[policy], params["none"]) <= 1e-6


# ---------------------------------------------------------------------------
# bf16 loss scaling
# ---------------------------------------------------------------------------


def _scale_state(opt):
    return tuple(float(np.asarray(opt[k]).item()) if k == "loss_scale"
                 else int(np.asarray(opt[k]).item())
                 for k in plow.OPT_SCALE_KEYS)


class TestLossScaling:
    def test_helpers_match_jax_on_the_same_gradients(self, monkeypatch):
        from deeplearning4j_tpu.ops import lowprec as jlow

        for spec in ("", "1024", "8:3", "junk:x", "0.5:0"):
            monkeypatch.setenv("DL4J_TPU_LOSS_SCALE", spec)
            assert plow.loss_scale_config() == jlow.loss_scale_config()
        monkeypatch.setenv("DL4J_TPU_LOSS_SCALE", "64:2")
        rng = np.random.default_rng(0)
        js, ps = jlow.init_scale_state(), plow.init_scale_state()
        for i in range(9):
            g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
                 "b": {"c": rng.standard_normal(5).astype(np.float32)}}
            if i in (2, 6, 7):
                g["b"]["c"][1] = np.inf if i != 6 else np.nan
            jg, pg = _to_jax(g), _to_port(g)
            jf, pf = jlow.finite_tree(jg), plow.finite_tree(pg)
            assert bool(jf) == bool(pf)
            ju = jlow.unscale(jg, js["scale"])
            pu = plow.unscale(pg, ps["scale"])
            if bool(pf):
                assert _max_diff(pu, jax.tree_util.tree_map(np.asarray,
                                                            ju)) == 0.0
            js, ps = jlow.advance_scale(js, jf), plow.advance_scale(ps, pf)
            assert jlow.scale_snapshot(js) == plow.scale_snapshot(ps)
        sel = plow.select_trees(torch.tensor(False), {"a": torch.ones(2)},
                                {"a": torch.zeros(2)})
        assert torch.equal(sel["a"], torch.zeros(2))

    def test_step_state_follows_jax(self, monkeypatch):
        """Five clean steps at growth 2 (two doublings), then a step whose
        gradients are not finite (an inf in an embedding row: the tied
        head's logits for that token are inf): skipped, scale halved, t
        and the params kept — in both packages."""
        jtr = _jtr()
        monkeypatch.setenv("DL4J_TPU_BF16", "1")
        monkeypatch.setenv("DL4J_TPU_LOSS_SCALE", "8:2")
        jcfg, pcfg = _cfgs()
        tree = _jax_params()
        jp = _to_jax(tree)
        jo = jtr.init_opt_state(jp)
        pp = _to_port(tree)
        po = pt.init_opt_state(pp)
        assert set(po) == set(jo)
        jstep, pstep = jtr.make_train_step(jcfg), pt.make_train_step(pcfg)
        for seed in range(5):
            x, y = _batch(seed)
            jp, jo, jl = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y))
            pp, po, pl = pstep(pp, po, torch.from_numpy(x),
                               torch.from_numpy(y))
            assert _scale_state(po) == _scale_state(jo)
            assert abs(float(jl) - float(pl)) <= 1e-3
        assert _scale_state(po) == (32.0, 1, 0)
        poisoned = dict(jax.tree_util.tree_map(np.asarray, jp))
        poisoned["embed"] = poisoned["embed"].copy()
        poisoned["embed"][7, 0] = np.inf
        jp = _to_jax(poisoned)
        pp = dict(pp, embed=torch.from_numpy(poisoned["embed"].copy()))
        x, y = _batch(9)
        jp2, jo2, _ = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y))
        pp2, po2, _ = pstep(pp, po, torch.from_numpy(x), torch.from_numpy(y))
        assert _scale_state(po2) == _scale_state(jo2) == (16.0, 0, 1)
        assert int(po2["t"]) == int(jo2["t"]) == 5
        for k in ("Wq", "W1"):
            assert torch.equal(pp2["blocks"][k], pp["blocks"][k])
            np.testing.assert_array_equal(np.asarray(jp2["blocks"][k]),
                                          np.asarray(jp["blocks"][k]))
        assert torch.equal(po2["m"]["pos"], po["m"]["pos"])

    def test_scale_rides_the_zip(self, monkeypatch, tmp_path):
        jtr = _jtr()
        monkeypatch.setenv("DL4J_TPU_BF16", "1")
        monkeypatch.setenv("DL4J_TPU_LOSS_SCALE", "64:1")
        _, pcfg = _cfgs()
        lm = pt.TransformerLM(pcfg, device="cpu",
                              params=_to_port(_jax_params()))
        x, y = _batch(0)
        lm.fit(x, y)
        path = str(tmp_path / "lm.zip")
        lm.save(path)
        jlm = jtr.TransformerLM.load(path)
        assert _scale_state(jax.tree_util.tree_map(np.asarray, jlm.opt)) \
            == _scale_state(lm.opt) == (128.0, 0, 0)
        back = pt.TransformerLM.load(path, device="cpu")
        assert _scale_state(back.opt) == (128.0, 0, 0)

    @pytest.mark.parametrize("on", [True, False])
    def test_knob_read_once_when_the_model_is_built(self, monkeypatch, on):
        """``DL4J_TPU_BF16`` as it stood when the LM was built decides the
        step, its opt dict and ``fit_batches``'s steps, even when it
        changes before the first fit."""
        monkeypatch.setenv("DL4J_TPU_BF16", "1" if on else "0")
        monkeypatch.setenv("DL4J_TPU_LOSS_SCALE", "64:1")
        _, pcfg = _cfgs()
        lm = pt.TransformerLM(pcfg, device="cpu",
                              params=_to_port(_jax_params()))
        monkeypatch.setenv("DL4J_TPU_BF16", "0" if on else "1")
        x, y = _batch(0)
        lm.fit(x, y)
        xs, ys = _batch(1, k=2)
        losses = lm.fit_batches(xs, ys)
        assert torch.isfinite(losses).all() and lm.iteration == 3
        assert set(plow.OPT_SCALE_KEYS) <= set(lm.opt) if on else \
            not set(plow.OPT_SCALE_KEYS) & set(lm.opt)
        if on:
            assert _scale_state(lm.opt) == (512.0, 0, 0)


# ---------------------------------------------------------------------------
# the model surface
# ---------------------------------------------------------------------------


def _pair(**kw):
    jtr = _jtr()
    jcfg, pcfg = _cfgs(**kw)
    tree = _jax_params()
    jlm = jtr.TransformerLM(jcfg)
    jlm.params = _to_jax(tree)
    plm = pt.TransformerLM(pcfg, device="cpu",
                           params=pt.params_from_numpy(tree, device="cpu"))
    return jlm, plm


class TestModelSurface:
    def test_fit_iterator_listeners_and_iteration_carry(self):
        from deeplearning4j_tpu.datasets.iterator import (
            ListDataSetIterator as JIter,
        )
        from deeplearning4j_tpu.optimize.listeners import (
            CollectScoresIterationListener as JCollect,
        )

        jlm, plm = _pair()
        x, y = _batch(3, n=12)
        jcol, pcol = JCollect(), CollectScoresIterationListener()
        for _ in range(2):  # two calls: the iteration carries over
            jlm.fit_iterator(JIter(x, y, batch=4), listeners=[jcol])
            plm.fit_iterator(ListDataSetIterator(x, y, batch=4),
                             listeners=[pcol])
        assert [i for i, _ in pcol.scores] == [1, 2, 3, 4, 5, 6]
        assert [i for i, _ in jcol.scores] == [i for i, _ in pcol.scores]
        assert plm.iteration == jlm.iteration == 6
        assert max(abs(a - b) for (_, a), (_, b)
                   in zip(jcol.scores, pcol.scores)) <= TOL_F32

    def test_evaluate_masked_matches_jax(self):
        from deeplearning4j_tpu.datasets.iterator import (
            ListDataSetIterator as JIter,
        )

        jlm, plm = _pair()
        x, y = _batch(8, n=10)
        rng = np.random.default_rng(1)
        lengths = rng.integers(4, T + 1, 10)
        mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
        j = jlm.evaluate(JIter(x, y, batch=4, label_masks=mask))
        p = plm.evaluate(ListDataSetIterator(x, y, batch=4,
                                             label_masks=mask))
        assert p["tokens"] == j["tokens"] == int(mask.sum())
        assert abs(p["loss"] - j["loss"]) <= 1e-5
        assert abs(p["perplexity"] - j["perplexity"]) \
            <= 1e-5 * j["perplexity"]
        j = jlm.evaluate(JIter(x, y, batch=4))
        p = plm.evaluate(ListDataSetIterator(x, y, batch=4))
        assert p["tokens"] == j["tokens"] == 10 * T
        assert abs(p["loss"] - j["loss"]) <= 1e-5

    def test_port_zip_loads_in_jax(self, tmp_path):
        jtr = _jtr()
        _, plm = _pair(weight_decay=0.01)
        for seed in range(2):
            plm.fit(*_batch(seed))
        path = str(tmp_path / "port.zip")
        plm.save(path)
        jlm = jtr.TransformerLM.load(path)
        assert jlm.cfg == _cfgs(weight_decay=0.01)[0]
        assert jlm.iteration == 2
        assert _max_diff(plm.params, jax.tree_util.tree_map(
            np.asarray, jlm.params)) == 0.0
        jo = jax.tree_util.tree_map(np.asarray, jlm.opt)
        for key in ("m", "v"):
            assert _max_diff(plm.opt[key], jo[key]) == 0.0
        assert jo["t"].dtype == np.int32 and int(jo["t"]) == 2

    def test_jax_zip_loads_in_port(self, tmp_path):
        jlm, _ = _pair()
        for seed in range(3):
            x, y = _batch(seed)
            jlm.fit(jnp.asarray(x), jnp.asarray(y))
        path = str(tmp_path / "jax.zip")
        jlm.save(path)
        plm = pt.TransformerLM.load(path, device="cpu")
        assert plm.cfg == _cfgs()[1] and plm.iteration == 3
        assert _max_diff(plm.params, jax.tree_util.tree_map(
            np.asarray, jlm.params)) == 0.0
        jo = jax.tree_util.tree_map(np.asarray, jlm.opt)
        for key in ("m", "v"):
            assert _max_diff(plm.opt[key], jo[key]) == 0.0
        assert plm.opt["t"].dtype == torch.int32
        bare = pt.TransformerLM.load(path, device="cpu", load_updater=False)
        assert bare.iteration == 0 and int(bare.opt["t"]) == 0
        # training on from the loaded state follows the JAX package
        x, y = _batch(7)
        jl = jlm.fit(jnp.asarray(x), jnp.asarray(y))
        pl = plm.fit(x, y)
        assert abs(float(jl) - float(pl)) <= TOL_F32

    def test_fit_runs_attention_through_flash_fn_on_cpu(self):
        _, plm = _pair()
        before = (pflash.flash_attention_plain.launches,
                  pflash.flash_block_bwd.launches, pflash.flash_bwd.launches)
        x, y = _batch(0)
        logits0 = plm.logits(x)
        plm.fit(x, y)
        layers = plm.cfg.n_layers
        after = (pflash.flash_attention_plain.launches,
                 pflash.flash_block_bwd.launches, pflash.flash_bwd.launches)
        # logits (one forward) + fit (forward, backward); K7's wrapper
        # sends CPU tensors to its plain version
        assert after[0] - before[0] == 2 * layers
        assert after[1] - before[1] == layers
        assert after[2] == before[2]
        # serving reads the trained weights
        logits1 = plm.logits(x)
        assert not torch.equal(logits0, logits1)
        want, _ = pt.forward(plm.params, torch.from_numpy(x), plm.cfg)
        assert torch.equal(logits1, want.detach())
        assert plm.output(x).shape == (N, T, CFG_KW["vocab_size"])
