"""The port's TransformerLM against the JAX package on the CPU.

Small model (vocab 64, d_model 64, 2 layers, 4 heads, d_ff 128, max_len
128 — the shape of ``bench.py:1807``) in f32 ``strict``. The weights come
from the JAX package's own init and are handed to the port two ways: the
JAX ``TransformerLM.save`` zip read by the port's reader, and
``params_from_numpy`` on the numpy tree. Both must give bit-equal f32
tensors. Then ``forward`` logits, ``prefill_cache`` K/V and hidden at two
bucket widths, and 4 successive ``paged_decode_step`` logits agree with
the JAX functions to 1e-4 abs (f32 GEMMs summed in another order).

Also: the port's copies of ``bucket_size``, ``kv_block_bytes`` /
``kv_arena_blocks`` and ``parse_slo_classes`` equal the JAX ones.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.models import transformer as pt  # noqa: E402

TOL = 1e-4
CFG_KW = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, d_ff=128,
              max_len=128)


@pytest.fixture(scope="module")
def pair():
    """(jax_lm, port_lm) holding the same f32 weights."""
    from deeplearning4j_tpu.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    jlm = TransformerLM(TransformerConfig(**CFG_KW, seed=3))
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    plm = pt.TransformerLM(pt.TransformerConfig(**CFG_KW, seed=3),
                           device="cpu",
                           params=pt.params_from_numpy(tree, device="cpu"))
    return jlm, plm


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _assert_bit_equal(port_params, jax_params):
    jtree = dict(_leaves(jax.tree_util.tree_map(np.asarray, jax_params)))
    ptree = dict(_leaves(port_params))
    assert sorted(jtree) == sorted(ptree)
    for key, a in jtree.items():
        b = ptree[key]
        assert b.dtype == torch.float32, key
        np.testing.assert_array_equal(b.numpy(), a, err_msg=str(key))


class TestWeights:
    def test_jax_zip_loads_bit_equal(self, pair, tmp_path):
        jlm, _ = pair
        path = str(tmp_path / "lm.zip")
        jlm.save(path)
        lm = pt.TransformerLM.load(path, device="cpu")
        assert lm.cfg == pt.TransformerConfig(**CFG_KW, seed=3)
        _assert_bit_equal(lm.params, jlm.params)

    def test_params_from_numpy_bit_equal(self, pair):
        jlm, plm = pair
        _assert_bit_equal(plm.params, jlm.params)

    def test_params_from_numpy_refuses_other_trees(self):
        with pytest.raises(ValueError, match="dense TransformerLM"):
            pt.params_from_numpy({"embed": np.zeros((2, 2))}, device="cpu")

    def test_config_has_the_jax_fields_and_defaults(self):
        import dataclasses

        from deeplearning4j_tpu.models.transformer import TransformerConfig

        jf = {f.name: f.default for f in dataclasses.fields(TransformerConfig)}
        pf = {f.name: f.default for f in dataclasses.fields(pt.TransformerConfig)}
        assert jf == pf

    def test_init_params_distributions(self):
        cfg = pt.TransformerConfig(vocab_size=512, d_model=128, n_layers=2,
                                   n_heads=4, d_ff=256, max_len=64)
        p = pt.init_params(cfg, device="cpu")
        b = p["blocks"]
        assert abs(b["Wq"].std().item() - (2 / 256) ** 0.5) < 5e-3
        assert abs(b["Wo"].std().item() - 0.02 / 2) < 1e-3
        assert abs(p["embed"].std().item() - 0.02) < 1e-3
        assert abs(p["pos"].std().item() - 0.01) < 1e-3
        assert torch.equal(b["ln1_g"], torch.ones(2, 128))
        assert torch.equal(b["b1"], torch.zeros(2, 256))
        again = pt.init_params(cfg, device="cpu")
        assert torch.equal(p["embed"], again["embed"])  # seeded

    def test_moe_is_refused(self):
        with pytest.raises(ValueError, match="MoE"):
            pt.TransformerLM(pt.TransformerConfig(moe_experts=2),
                             device="cpu")


class TestForwardAgainstJax:
    @pytest.mark.parametrize("use_flash", [True, False])
    def test_forward_logits(self, pair, use_flash):
        import dataclasses

        from deeplearning4j_tpu.models.transformer import forward

        jlm, plm = pair
        cfg_j = dataclasses.replace(jlm.cfg, use_flash=use_flash)
        cfg_p = dataclasses.replace(plm.cfg, use_flash=use_flash)
        toks = np.random.default_rng(0).integers(0, 64, (2, 24), np.int32)
        ref = np.asarray(forward(jlm.params, jnp.asarray(toks), cfg_j)[0])
        out = pt.forward(plm.compute_params, torch.from_numpy(toks),
                         cfg_p)[0].numpy()
        assert out.shape == (2, 24, 64)
        assert np.abs(out - ref).max() < TOL
        if use_flash:  # the model object's surface runs the same forward
            np.testing.assert_array_equal(plm.logits(toks).numpy(), out)

    @pytest.mark.parametrize("width", [48, 96])
    def test_prefill_cache(self, pair, width):
        from deeplearning4j_tpu.models.transformer import prefill_cache

        jlm, plm = pair
        toks = np.random.default_rng(width).integers(0, 64, (1, width),
                                                     np.int32)
        jc, jh = prefill_cache(jlm.params, jnp.asarray(toks), jlm.cfg)
        pc, ph = pt.prefill_cache(plm.compute_params,
                                  torch.from_numpy(toks), plm.cfg)
        assert pc["k"].shape == (2, 1, 128, 4, 16)
        for name in ("k", "v"):
            assert np.abs(pc[name].numpy()
                          - np.asarray(jc[name])).max() < TOL
        assert np.abs(ph.numpy() - np.asarray(jh)).max() < TOL

    def test_paged_decode_steps(self, pair):
        """4 successive ticks over the same arena, tables and positions:
        logits agree at every step, and so does the arena they wrote."""
        from deeplearning4j_tpu.serving.paged import (
            paged_decode_step as jax_step,
        )
        from deeplearning4j_tpu_torch.serving.paged import (
            paged_decode_step as port_step,
        )

        jlm, plm = pair
        rng = np.random.default_rng(11)
        bt, n_blocks, s, m = 16, 20, 5, 8
        shape = (2, n_blocks + 1, bt, 4, 16)
        ak = rng.standard_normal(shape).astype(np.float32)
        av = rng.standard_normal(shape).astype(np.float32)
        tables = np.zeros((s, m), np.int32)
        pos = np.array([0, 14, 15, 40, 100], np.int32)
        perm = rng.permutation(np.arange(1, n_blocks + 1))
        nxt = 0
        for i in range(s):
            used = (int(pos[i]) + 4) // bt + 1  # room for the 4 ticks
            tables[i, :used] = perm[nxt:nxt + used]
            nxt += used
        tok = rng.integers(0, 64, (s,), np.int32)
        j_arena = {"k": jnp.asarray(ak), "v": jnp.asarray(av)}
        p_arena = {"k": torch.from_numpy(ak.copy()),
                   "v": torch.from_numpy(av.copy())}
        for _ in range(4):
            j_arena, jl = jax_step(jlm.params, j_arena, jnp.asarray(tok),
                                   jnp.asarray(pos), jnp.asarray(tables),
                                   jlm.cfg)
            p_arena, pl = port_step(plm.compute_params, p_arena,
                                    torch.from_numpy(tok),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(tables), plm.cfg)
            jl = np.asarray(jl)
            assert np.abs(pl.numpy() - jl).max() < TOL
            tok = jl.argmax(-1).astype(np.int32)
            pos = pos + 1
        for name in ("k", "v"):
            assert np.abs(p_arena[name].numpy()
                          - np.asarray(j_arena[name])).max() < TOL


class TestHelpersAgainstJax:
    def test_bucket_size(self):
        from deeplearning4j_tpu.ops.dispatch import bucket_size as jb

        from deeplearning4j_tpu_torch.ops.dispatch import bucket_size

        assert [bucket_size(n) for n in range(0, 2050)] == \
            [jb(n) for n in range(0, 2050)]

    @pytest.mark.parametrize("policy", ["strict", "performance"])
    def test_kv_arena_sizing_closed_form(self, pair, policy):
        from deeplearning4j_tpu.models.transformer import TransformerConfig
        from deeplearning4j_tpu.ops import memory as jm

        from deeplearning4j_tpu_torch.ops import memory as pm

        jlm, plm = pair
        jcfg = TransformerConfig(**CFG_KW, dtype_policy=policy)
        pcfg = pt.TransformerConfig(**CFG_KW, dtype_policy=policy)
        assert pm.kv_block_bytes(pcfg, 16) == jm.kv_block_bytes(jcfg, 16)
        for gb in (0.0005, 0.004, 0.05, 80.0):
            assert pm.kv_arena_blocks(
                pcfg, 16, budget_bytes=gb * 2 ** 30, params=plm.params) \
                == jm.kv_arena_blocks(jcfg, 16, hbm_gb=gb,
                                      params=jlm.params), gb

    def test_slo_parse(self):
        from deeplearning4j_tpu.serving.slo import parse_slo_classes as jp

        from deeplearning4j_tpu_torch.serving.slo import parse_slo_classes

        spec = "interactive:5, batch:60,bulk:600"
        assert [(c.name, c.deadline_s, c.priority)
                for c in parse_slo_classes(spec)] == \
            [(c.name, c.deadline_s, c.priority) for c in jp(spec)]
        for bad in ("x", "a:1,a:2", "a:-1", "a:zz"):
            with pytest.raises(ValueError):
                parse_slo_classes(bad)
