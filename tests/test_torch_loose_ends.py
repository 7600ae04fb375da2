"""The loose ends of the port's shared modules against the JAX package,
on the CPU.

  * ``MultiLayerConfiguration.to_yaml`` and ``from_yaml``: the port's
    YAML equals JAX's for the same configuration, and each package reads
    the other's.
  * ``ModelSerializer.restore_multi_layer_network`` and
    ``restore_computation_graph``: the port restores a JAX zip of each
    container, ``output`` within 1e-5 of JAX's.
  * ``ServingEngine.input_shape``.
  * ``ops/env.py``'s ``knob_names``, ``is_registered`` and ``nonempty``.
  * ``ops/dtypes.py``'s ``DtypePolicy``, ``STRICT``, ``PERFORMANCE``,
    ``get_policy``, ``set_policy`` and ``float32_strict``.
  * ``ops/memory.py``'s ``transformer_preflight``: param, optimizer and
    gradient bytes exactly JAX's ``jax.eval_shape`` counts (dense, MoE,
    bf16 training), the analytic activation and logit counts and the
    report equal to JAX's (``measure_aot=False``); ``auto_fit_transformer``
    picks JAX's triple.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side

from deeplearning4j_tpu.models import transformer as jtfm  # noqa: E402
from deeplearning4j_tpu.ops import memory as jmem  # noqa: E402
from deeplearning4j_tpu_torch.models import transformer as ptfm  # noqa: E402
from deeplearning4j_tpu_torch.ops import memory as pmem  # noqa: E402

yaml = pytest.importorskip("yaml")


def _confs():
    from deeplearning4j_tpu.models.char_rnn import char_rnn_conf as jchar
    from deeplearning4j_tpu.models.lenet import lenet5_conf as jlenet
    from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_conf
    from deeplearning4j_tpu_torch.models.lenet import lenet5_conf

    return [(jlenet(), lenet5_conf()),
            (jchar(30, lstm_size=16, tbptt_length=8),
             char_rnn_conf(30, lstm_size=16, tbptt_length=8))]


class TestYaml:
    @pytest.mark.parametrize("i", [0, 1])
    def test_yaml_equals_jax_both_ways(self, i):
        from deeplearning4j_tpu.nn.conf.multi_layer import (
            MultiLayerConfiguration as JConf,
        )
        from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
            MultiLayerConfiguration as PConf,
        )

        j, p = _confs()[i]
        assert p.to_yaml() == j.to_yaml()
        assert PConf.from_yaml(j.to_yaml()).to_json() == j.to_json()
        assert JConf.from_yaml(p.to_yaml()).to_json() == p.to_json()
        assert PConf.from_yaml(p.to_yaml()).to_yaml() == p.to_yaml()


class TestRestore:
    def test_restore_multi_layer_network(self, tmp_path):
        from deeplearning4j_tpu.models.lenet import build_lenet5
        from deeplearning4j_tpu.utils.serialization import (
            ModelSerializer as J,
        )
        from deeplearning4j_tpu_torch.utils.serialization import (
            ModelSerializer as P,
        )

        jnet = build_lenet5(seed=3)
        path = str(tmp_path / "lenet.zip")
        J.write_model(jnet, path)
        pnet = P.restore_multi_layer_network(path, device="cpu")
        x = np.random.default_rng(0).random((3, 28, 28, 1)).astype(
            np.float32)
        np.testing.assert_allclose(pnet.output(x).numpy(),
                                   np.asarray(jnet.output(x)), atol=1e-5)
        assert type(pnet).__name__ == "MultiLayerNetwork"
        no_upd = P.restore_multi_layer_network(path, load_updater=False,
                                               device="cpu")
        assert no_upd.iteration == jnet.iteration

    def test_restore_computation_graph(self, tmp_path):
        from deeplearning4j_tpu.nn import conf as jconf
        from deeplearning4j_tpu.nn.graph import ComputationGraph
        from deeplearning4j_tpu.utils.serialization import (
            ModelSerializer as J,
        )
        from deeplearning4j_tpu_torch.utils.serialization import (
            ModelSerializer as P,
        )

        conf = (jconf.NeuralNetConfiguration.builder().seed(1)
                .graph_builder().add_inputs("in")
                .add_layer("d", jconf.DenseLayer(n_in=4, n_out=5,
                                                 activation="tanh"), "in")
                .add_layer("out", jconf.OutputLayer(n_in=5, n_out=3), "d")
                .set_outputs("out").build())
        jnet = ComputationGraph(conf).init()
        path = str(tmp_path / "g.zip")
        J.write_model(jnet, path)
        pnet = P.restore_computation_graph(path, device="cpu")
        x = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32)
        got = pnet.output(x)
        got = (got[0] if isinstance(got, (list, tuple)) else got).numpy()
        want = jnet.output(x)
        want = np.asarray(want[0] if isinstance(want, (list, tuple))
                          else want)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_restore_needs_a_card_or_cpu(self, tmp_path, monkeypatch):
        from deeplearning4j_tpu_torch.nn import conf as pconf
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.utils.serialization import (
            ModelSerializer as P,
            write_model,
        )

        conf = (pconf.NeuralNetConfiguration.builder().seed(1).list()
                .layer(0, pconf.OutputLayer(n_in=4, n_out=3)).build())
        path = str(tmp_path / "m.zip")
        write_model(MultiLayerNetwork(conf, device="cpu").init(), path)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.restore_multi_layer_network(path)


def test_engine_input_shape():
    from deeplearning4j_tpu_torch.nn import conf as pconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine

    conf = (pconf.NeuralNetConfiguration.builder().seed(1).list()
            .layer(0, pconf.OutputLayer(n_in=4, n_out=3)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    eng = ServingEngine(model=net, input_shape=(2, 2), device="cpu")
    try:
        assert eng.input_shape == eng.registry.default().input_shape
        assert eng.input_shape == (2, 2)
    finally:
        eng.stop()
    empty = ServingEngine(device="cpu")
    try:
        assert empty.input_shape is None
    finally:
        empty.stop()


class TestEnv:
    def test_knob_names_and_is_registered(self):
        from deeplearning4j_tpu.ops import env as jenv
        from deeplearning4j_tpu_torch.ops import env as penv

        names = penv.knob_names()
        assert list(names) == sorted(penv.KNOBS)
        assert set(names) <= set(jenv.knob_names())
        for n in names:
            assert penv.is_registered(n) and jenv.is_registered(n)
        assert not penv.is_registered("DL4J_TPU_NOPE")
        assert not jenv.is_registered("DL4J_TPU_NOPE")

    @pytest.mark.parametrize("value", [None, "", "0", "1", "off", "x"])
    def test_nonempty_equals_jax(self, value, monkeypatch):
        from deeplearning4j_tpu.ops import env as jenv
        from deeplearning4j_tpu_torch.ops import env as penv

        if value is None:
            monkeypatch.delenv("DL4J_TPU_BF16", raising=False)
        else:
            monkeypatch.setenv("DL4J_TPU_BF16", value)
        assert penv.nonempty("DL4J_TPU_BF16") == jenv.nonempty(
            "DL4J_TPU_BF16")
        with pytest.raises(KeyError):
            penv.nonempty("DL4J_TPU_NOPE")


class TestDtypes:
    def test_policies_mirror_jax(self):
        from deeplearning4j_tpu.ops import dtypes as jd
        from deeplearning4j_tpu_torch.ops import dtypes as pd

        for name in ("STRICT", "PERFORMANCE"):
            j, p = getattr(jd, name), getattr(pd, name)
            for f in ("param_dtype", "compute_dtype", "output_dtype"):
                assert str(getattr(p, f)).split(".")[-1] == \
                    np.dtype(getattr(j, f)).name
            assert p.matmul_precision == j.matmul_precision
        x = pd.PERFORMANCE.cast_compute(np.ones(3, np.float32))
        assert x.dtype == torch.bfloat16
        assert pd.STRICT.cast_param(x).dtype == torch.float32
        assert pd.STRICT.cast_output([1, 2]).dtype == torch.float32

    def test_set_get_and_float32_strict(self):
        from deeplearning4j_tpu_torch.ops import dtypes as pd

        prev = pd.get_policy()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        try:
            pd.set_policy(pd.PERFORMANCE)
            torch.backends.cuda.matmul.allow_tf32 = True
            with pd.float32_strict():
                assert pd.get_policy() is pd.STRICT
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
            assert pd.get_policy() is pd.PERFORMANCE
            assert torch.backends.cuda.matmul.allow_tf32
        finally:
            pd.set_policy(prev)
            torch.backends.cuda.matmul.allow_tf32 = tf32

    @pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16,
                                    torch.float32, torch.float64])
    def test_softmax_dtype(self, dt):
        from deeplearning4j_tpu_torch.ops import dtypes as pd

        assert pd.softmax_dtype(dt) == torch.promote_types(dt, torch.float32)


CFGS = [
    dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
         max_len=32),
    dict(vocab_size=8192, d_model=2048, n_layers=4, n_heads=32, d_ff=8192,
         max_len=1024),
    dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
         max_len=64, moe_experts=4, moe_top_k=2),
    dict(vocab_size=256, d_model=64, n_layers=3, n_heads=4, d_ff=256,
         max_len=32, dtype_policy="performance"),
]


class TestPreflight:
    @pytest.mark.parametrize("i", range(len(CFGS)))
    @pytest.mark.parametrize("remat", ["none", "dots", "block"])
    @pytest.mark.parametrize("accum", [1, 2])
    def test_report_equals_jax(self, i, remat, accum):
        kw = CFGS[i]
        ok_p, rp = pmem.transformer_preflight(
            ptfm.TransformerConfig(**kw), 8, accum_steps=accum, remat=remat,
            hbm_gb=2.0)
        ok_j, rj = jmem.transformer_preflight(
            jtfm.TransformerConfig(**kw), 8, accum_steps=accum, remat=remat,
            hbm_gb=2.0, measure_aot=False)
        assert ok_p == ok_j
        assert {k: v for k, v in rp.items() if k != "bytes"} == rj
        p_shapes = jax.eval_shape(
            lambda: jtfm.init_params(jtfm.TransformerConfig(**kw)))
        assert rp["bytes"]["params"] == jmem._tree_bytes(p_shapes)
        assert rp["bytes"]["opt"] == jmem._tree_bytes(
            jax.eval_shape(jtfm.init_opt_state, p_shapes))
        assert rp["bytes"]["grads"] == rp["bytes"]["params"] * (
            2 if accum > 1 else 1)

    def test_bf16_training_counts(self, monkeypatch):
        monkeypatch.setenv("DL4J_TPU_BF16", "1")
        kw = CFGS[0]
        _, rp = pmem.transformer_preflight(ptfm.TransformerConfig(**kw), 4)
        _, rj = jmem.transformer_preflight(jtfm.TransformerConfig(**kw), 4,
                                           measure_aot=False)
        assert rp["train_dtype"] == rj["train_dtype"] == "bf16"
        p_shapes = jax.eval_shape(
            lambda: jtfm.init_params(jtfm.TransformerConfig(**kw)))
        # a fresh function: eval_shape caches by function and shapes, and
        # the knob is read while tracing
        opt = jax.eval_shape(lambda p: jtfm.init_opt_state(p), p_shapes)
        # m, v, t and the loss-scale state
        n_params = len(jax.tree_util.tree_leaves(p_shapes))
        assert len(jax.tree_util.tree_leaves(opt)) > 2 * n_params + 1
        assert rp["bytes"]["opt"] == jmem._tree_bytes(opt)

    def test_preflight_allocates_nothing(self):
        kw = dict(CFGS[1], vocab_size=50_000, n_layers=48)
        ok, rep = pmem.transformer_preflight(ptfm.TransformerConfig(**kw),
                                             32, hbm_gb=80.0)
        assert rep["params_gb"] > 9.0

    def test_batch_must_divide(self):
        with pytest.raises(ValueError, match="divisible"):
            pmem.transformer_preflight(ptfm.TransformerConfig(**CFGS[0]), 6,
                                       accum_steps=4)

    @pytest.mark.parametrize("hbm", [0.01, 0.2, 4.0, 1e-6])
    def test_auto_fit_equals_jax(self, hbm, monkeypatch):
        monkeypatch.setattr(jmem, "_cpu_substrate", lambda: False)
        kw = CFGS[1]
        p = pmem.auto_fit_transformer(ptfm.TransformerConfig(**kw),
                                      hbm_gb=hbm)
        j = jmem.auto_fit_transformer(jtfm.TransformerConfig(**kw),
                                      hbm_gb=hbm)
        if j is None:
            assert p is None
        else:
            assert (p["batch"], p["accum_steps"], p["remat"]) == (
                j["batch"], j["accum_steps"], j["remat"])
