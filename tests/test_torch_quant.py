"""The port's calibrated int8 ``/predict`` and fitted normalizers against
the JAX package, on the CPU at small widths.

  * Normalizers: ``NormalizerStandardize``, ``NormalizerMinMaxScaler`` and
    ``ImagePreProcessingScaler`` fitted on one seeded array agree at 1e-6
    (transform and revert, [N, F] and [N, T, F]); a JAX ``normalizer.json``
    loads in the port and the port's in JAX.
  * Calibration: ``QuantCalibrator`` over one net and one set of batches
    gives the same scales (1e-6 relative), audit moments and gate sample.
  * ``int8_dense``: on identical inputs the int8 codes and the int32
    accumulators are bit-equal to JAX's and the outputs agree at 1e-5.
  * ``QuantizedNet`` on a small char-RNN (vocab 12, LSTM 16) and a small
    MLP: for each quantized layer the int8 codes of its input agree
    between packages except for one-step tie flips in at most 1e-4 of the
    entries (the count is printed), and the outputs agree within 1e-5
    plus the sum of |dcode| * x_scale * w_scale * |w_q| over the flips.
  * The gate: ``_maybe_quantize`` gives JAX's verdict and delta (1e-5)
    for ok, ungated, forced, forced-ungated and gate-failed; a
    gate-failed load lands broken and the default does not move.
  * Zips: a JAX zip with both sections serves the same ``/predict``
    answers (1e-5) on both engines at equal batch shapes, and the port's
    zip loads in JAX with the same sections.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.etl import calibrate as p_cal  # noqa: E402
from deeplearning4j_tpu_torch.etl import normalize as p_norm  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.ops import lowprec as p_low  # noqa: E402
from deeplearning4j_tpu_torch.serving import registry as p_reg  # noqa: E402
from deeplearning4j_tpu_torch.utils import serialization as p_ser  # noqa: E402

VOCAB, HIDDEN, T = 12, 16, 10
MLP_IN, MLP_OUT = 20, 10
TIE_SHARE = 1e-4


def _jax_mlp():
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    conf = (NeuralNetConfiguration.builder().seed(3).learning_rate(0.05)
            .list()
            .layer(0, DenseLayer(n_in=MLP_IN, n_out=24, activation="relu"))
            .layer(1, DenseLayer(n_in=24, n_out=24, activation="tanh"))
            .layer(2, OutputLayer(n_in=24, n_out=MLP_OUT,
                                  activation="softmax",
                                  loss_function="mcxent"))
            .build())
    net = JNet(conf).init()
    rng = np.random.default_rng(0)
    for _ in range(3):
        net.fit(rng.normal(size=(32, MLP_IN)).astype(np.float32),
                np.eye(MLP_OUT, dtype=np.float32)[
                    rng.integers(0, MLP_OUT, 32)])
    return net


def _jax_char_rnn():
    from deeplearning4j_tpu.models.char_rnn import char_rnn_conf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    return JNet(char_rnn_conf(VOCAB, lstm_size=HIDDEN, num_layers=2,
                              seed=11)).init(input_shape=(1, VOCAB))


def _to_port(jnet, path):
    from deeplearning4j_tpu.utils.serialization import ModelSerializer

    ModelSerializer.write_model(jnet, path)
    return MultiLayerNetwork.load(path, device="cpu")


@pytest.fixture(scope="module")
def mlp_pair(tmp_path_factory):
    jnet = _jax_mlp()
    return jnet, _to_port(jnet, str(tmp_path_factory.mktemp("q") / "m.zip"))


@pytest.fixture(scope="module")
def rnn_pair(tmp_path_factory):
    jnet = _jax_char_rnn()
    return jnet, _to_port(jnet, str(tmp_path_factory.mktemp("q") / "r.zip"))


def _mlp_batches(seed=1, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(24, MLP_IN)).astype(np.float32)
            for _ in range(n)]


def _rnn_batches(seed=2, n=3):
    rng = np.random.default_rng(seed)
    eye = np.eye(VOCAB, dtype=np.float32)
    return [eye[rng.integers(0, VOCAB, (8, T))] for _ in range(n)]


def _specs(jnet, pnet, batches):
    from deeplearning4j_tpu.etl.calibrate import QuantCalibrator

    js = QuantCalibrator().fit(jnet, batches).spec(jnet)
    ps = p_cal.QuantCalibrator().fit(pnet, batches).spec(pnet)
    return js, ps


class TestNormalizers:
    @pytest.mark.parametrize("shape", [(64, 5), (16, 7, 5)])
    @pytest.mark.parametrize("kind", ["std", "minmax", "image"])
    def test_fit_transform_revert_agree(self, kind, shape):
        from deeplearning4j_tpu.etl import normalize as j_norm

        rng = np.random.default_rng(7)
        x = (rng.normal(size=shape) * 3 + 2).astype(np.float32)
        x[..., 1] = 4.0  # a constant column: std 0, span 0
        make = {"std": lambda m: m.NormalizerStandardize(),
                "minmax": lambda m: m.NormalizerMinMaxScaler(-1.0, 2.0),
                "image": lambda m: m.ImagePreProcessingScaler(0.0, 1.0)}[kind]
        jn, pn = make(j_norm).fit(x), make(p_norm).fit(x)
        for f in jn._FIELDS:
            a, b = getattr(jn, f), getattr(pn, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        y = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_allclose(pn.transform_array(y),
                                   jn.transform_array(y), atol=1e-6)
        np.testing.assert_allclose(pn.revert_array(y), jn.revert_array(y),
                                   atol=1e-6)
        assert pn.transform_array(y).dtype == np.float32

    def test_json_round_trips_both_ways(self):
        from deeplearning4j_tpu.etl import normalize as j_norm

        rng = np.random.default_rng(8)
        x = rng.normal(size=(40, 6)).astype(np.float32)
        y = rng.normal(size=(5, 6)).astype(np.float32)
        for make in (lambda m: m.NormalizerStandardize(),
                     lambda m: m.NormalizerMinMaxScaler(0.5, 3.0),
                     lambda m: m.ImagePreProcessingScaler(-1, 1, 4)):
            jn = make(j_norm).fit(x)
            pn = p_norm.normalizer_from_json(jn.to_json())
            assert type(pn).__name__ == type(jn).__name__
            np.testing.assert_array_equal(pn.transform_array(y),
                                          jn.transform_array(y))
            back = j_norm.normalizer_from_json(make(p_norm).fit(x).to_json())
            np.testing.assert_allclose(back.transform_array(y),
                                       jn.transform_array(y), atol=1e-6)
        with pytest.raises(ValueError, match="unknown normalizer"):
            p_norm.normalizer_from_json('{"class": "Nope"}')


class TestCalibration:
    @pytest.mark.parametrize("which", ["mlp", "rnn"])
    def test_scales_audit_and_sample_agree(self, which, mlp_pair, rnn_pair):
        jnet, pnet = mlp_pair if which == "mlp" else rnn_pair
        batches = _mlp_batches() if which == "mlp" else _rnn_batches()
        js, ps = _specs(jnet, pnet, batches)
        assert len(ps.act_scales) == len(js.act_scales)
        for a, b in zip(js.act_scales, ps.act_scales):
            assert (a is None) == (b is None)
            if a is not None:
                assert abs(b - a) <= 1e-6 * abs(a)
        for a, b in zip(js.audit, ps.audit):
            assert a.keys() == b.keys()
            for k in a:
                assert abs(b[k] - a[k]) <= 1e-6 * max(abs(a[k]), 1.0), k
        np.testing.assert_array_equal(ps.sample, js.sample)
        # the gate sample: the first 32 calibration rows
        assert ps.sample.shape[0] == min(32, sum(b.shape[0] for b in batches))
        assert ps.meta == js.meta
        back = p_cal.quant_spec_from_json(js.to_json())
        assert back.act_scales == js.act_scales
        from deeplearning4j_tpu.etl.calibrate import quant_spec_from_json

        assert quant_spec_from_json(ps.to_json()).act_scales == ps.act_scales


class TestInt8Dense:
    @pytest.mark.parametrize("m,k,n", [(1, 10, 10), (37, 24, 10),
                                       (64, 200, 80), (5, 3, 7)])
    def test_accumulators_bit_equal(self, m, k, n):
        from deeplearning4j_tpu.ops import lowprec as j_low

        rng = np.random.default_rng(m * 100 + k)
        x = (rng.normal(size=(m, k)) * 2).astype(np.float32)
        w = rng.normal(size=(k, n)).astype(np.float32)
        b = rng.normal(size=(n,)).astype(np.float32)
        x_scale = np.float32(np.abs(x).max() / 127.0)
        jwq, jws = j_low.quantize_weight(w)
        pwq, pws = p_low.quantize_weight(torch.from_numpy(w))
        np.testing.assert_array_equal(pwq.numpy(), np.asarray(jwq))
        np.testing.assert_array_equal(pws.numpy(), np.asarray(jws))
        pxs = torch.tensor(x_scale)
        codes = p_low.int8_quantize_rows(torch.from_numpy(x), pxs)
        jcodes = jnp.clip(jnp.round(jnp.asarray(x) / jnp.asarray(x_scale)),
                          -127, 127).astype(jnp.int8)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        acc = p_low.int8_matmul(codes, pwq)
        jacc = jax.lax.dot_general(jcodes, jwq, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        got = p_low.int8_dense(torch.from_numpy(x), pwq, pws, pxs,
                               torch.from_numpy(b))
        want = j_low.int8_dense(x, jwq, jws, jnp.asarray(x_scale), b)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_leading_axes_and_the_cpu_route(self):
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.normal(size=(2, 5, 6)).astype(np.float32))
        wq, ws = p_low.quantize_weight(torch.randn(6, 4))
        before = (p_low.int8_matmul.launches,
                  p_low.int8_matmul_plain.launches)
        y = p_low.int8_dense(x, wq, ws, torch.tensor(0.02))
        assert y.shape == (2, 5, 4)
        # on the CPU the plain version runs; the card's counter stays put
        assert p_low.int8_matmul.launches == before[0]
        assert p_low.int8_matmul_plain.launches == before[1] + 1


def _quantized_layer_inputs(jqnet, pqnet, x):
    """Each package's quantized forward on ``x``, recording every
    int8_dense input: ([jax inputs], jax out, [port inputs], port out)."""
    from deeplearning4j_tpu.ops import lowprec as j_low

    jin, pin = [], []
    j_orig, p_orig = j_low.int8_dense, p_low.int8_dense

    def j_rec(xx, *a, **kw):
        jin.append(np.asarray(xx))
        return j_orig(xx, *a, **kw)

    def p_rec(xx, *a, **kw):
        pin.append(xx.detach().cpu().numpy())
        return p_orig(xx, *a, **kw)

    j_low.int8_dense, p_low.int8_dense = j_rec, p_rec
    try:
        jout = np.asarray(jqnet._forward_quant(
            jqnet.params["base"], jqnet.params["quant"], jqnet.states,
            jnp.asarray(x)))
        with torch.inference_mode():
            pout = pqnet._forward_quant(
                pqnet.params["base"], pqnet.params["quant"], pqnet.states,
                torch.from_numpy(x)).numpy()
    finally:
        j_low.int8_dense, p_low.int8_dense = j_orig, p_orig
    return jin, jout, pin, pout


class TestQuantizedNet:
    @pytest.mark.parametrize("which", ["mlp", "rnn"])
    def test_per_code_bar(self, which, mlp_pair, rnn_pair):
        from deeplearning4j_tpu.ops import lowprec as j_low

        jnet, pnet = mlp_pair if which == "mlp" else rnn_pair
        batches = _mlp_batches() if which == "mlp" else _rnn_batches()
        js, ps = _specs(jnet, pnet, batches)
        jq, pq = j_low.QuantizedNet(jnet, js), p_low.QuantizedNet(pnet, ps)
        assert pq.quantized_layers() == jq.quantized_layers()
        assert pq.quantized_layers() == ([0, 1, 2] if which == "mlp"
                                         else [2])
        x = (_mlp_batches(9, 1) if which == "mlp" else _rnn_batches(9, 1))[0]
        jin, jout, pin, pout = _quantized_layer_inputs(jq, pq, x)
        assert len(jin) == len(pin) == len(pq.quantized_layers())
        rows = x.shape[0]
        bar = np.full(pout.shape[:-1], 1e-5)
        flips_total = entries_total = 0
        for li, xj, xp in zip(pq.quantized_layers(), jin, pin):
            q = pq.params["quant"][li]
            xs = float(q["x_scale"])
            cj = np.clip(np.round(xj.astype(np.float32) / np.float32(xs)),
                         -127, 127)
            cp = p_low.int8_quantize_rows(
                torch.from_numpy(xp), q["x_scale"]).numpy().reshape(cj.shape)
            d = np.abs(cp - cj)
            assert d.max() <= 1, f"layer {li}: a code moved by {d.max()}"
            flips_total += int((d > 0).sum())
            entries_total += d.size
            # each flipped input entry moves every output of its row by at
            # most x_scale * w_scale[j] * |w_q[k, j]|
            per_k = (q["w_scale"].numpy()[None, :]
                     * np.abs(q["wq"].numpy().astype(np.float64))).max(1)
            row_bar = (d.reshape(-1, d.shape[-1]) * xs * per_k).sum(1)
            bar = bar + row_bar.reshape(bar.shape)
        print(f"{which}: {flips_total} code flips of {entries_total} "
              "quantized-layer input entries")
        assert flips_total <= TIE_SHARE * entries_total + 1e-9 or \
            flips_total <= 1
        err = np.abs(pout - jout).max(-1)
        assert (err <= bar).all(), (err.max(), bar.min())
        # output() pads to the bucket and slices back
        got = pq.output(x[:rows - 1]).numpy()
        np.testing.assert_allclose(got, pout[:rows - 1], atol=1e-6)
        assert pq.precision == "int8" and pq._input_shape == \
            pnet._input_shape


class TestGate:
    CASES = [("", 0.05, True, "ok"), ("", 0.05, False, "ungated"),
             ("force", 1e-9, True, "forced"),
             ("force", 0.05, False, "forced-ungated"),
             ("", 1e-9, True, "QuantGateError"),
             ("off", 0.05, True, None)]

    @pytest.mark.parametrize("mode,max_delta,gated,want", CASES)
    def test_verdicts_and_deltas_match(self, mode, max_delta, gated, want,
                                       mlp_pair, monkeypatch):
        from deeplearning4j_tpu.ops import lowprec as j_low
        from deeplearning4j_tpu.serving import registry as j_reg

        monkeypatch.setenv("DL4J_TPU_QUANT", mode)
        monkeypatch.setenv("DL4J_TPU_QUANT_MAX_DELTA", str(max_delta))
        jnet, pnet = mlp_pair
        js, ps = _specs(jnet, pnet, _mlp_batches())
        if not gated:
            js.sample = ps.sample = None
        if want == "QuantGateError":
            with pytest.raises(j_low.QuantGateError):
                j_reg._maybe_quantize(jnet, js)
            with pytest.raises(p_low.QuantGateError, match="gate failed"):
                p_reg._maybe_quantize(pnet, ps)
            return
        jm, jinfo = j_reg._maybe_quantize(jnet, js)
        pm, pinfo = p_reg._maybe_quantize(pnet, ps)
        if want is None:
            assert jinfo is None and pinfo is None
            assert pm is pnet
            return
        assert pinfo["verdict"] == jinfo["verdict"] == want
        assert pinfo["layers"] == jinfo["layers"]
        assert pinfo["mode"] == jinfo["mode"]
        assert pinfo["max_delta"] == jinfo["max_delta"]
        assert (pinfo["delta"] is None) == (jinfo["delta"] is None)
        if jinfo["delta"] is not None:
            assert abs(pinfo["delta"] - jinfo["delta"]) <= 1e-5
        assert type(pm).__name__ == type(jm).__name__

    def test_gate_failure_lands_broken_and_keeps_the_default(
            self, mlp_pair, monkeypatch):
        jnet, pnet = mlp_pair
        _, ps = _specs(jnet, pnet, _mlp_batches())
        reg = p_reg.ModelRegistry(device="cpu")
        good = reg.load("m", model=pnet)
        reg.serve("m")
        monkeypatch.setenv("DL4J_TPU_QUANT_MAX_DELTA", "1e-9")
        with pytest.raises(p_low.QuantGateError):
            reg.load("m", model=pnet, quant=ps)
        bad = reg.get("m", 2)
        assert bad.state == "broken" and "QuantGateError" in bad.error
        assert bad.model is None and reg.get() is good
        with pytest.raises(ValueError, match="refusing to serve"):
            reg.serve("m", 2)
        monkeypatch.setenv("DL4J_TPU_QUANT_MAX_DELTA", "0.05")
        rec = reg.load("m", model=pnet, quant=ps)
        assert rec.precision == "int8" and rec.quant["verdict"] == "ok"
        assert rec.describe()["quant"]["verdict"] == "ok"


class TestZips:
    def test_jax_zip_serves_the_same_answers_on_both_engines(
            self, mlp_pair, tmp_path):
        from deeplearning4j_tpu.etl.normalize import NormalizerStandardize
        from deeplearning4j_tpu.serving.engine import (
            ServingEngine as JaxEngine,
        )
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        from deeplearning4j_tpu_torch.serving.engine import ServingEngine

        jnet, pnet = mlp_pair
        rng = np.random.default_rng(5)
        norm = NormalizerStandardize().fit(
            (rng.normal(size=(64, MLP_IN)) * 2 + 1).astype(np.float32))
        js, _ = _specs(jnet, pnet, _mlp_batches())
        path = str(tmp_path / "both.zip")
        ModelSerializer.write_model(jnet, path, normalizer=norm, quant=js)
        assert type(p_ser.read_normalizer(path)).__name__ == \
            "NormalizerStandardize"
        assert p_ser.read_quant(path).act_scales == js.act_scales
        assert p_ser.read_quant(str(tmp_path)) is None  # a directory
        x = rng.normal(size=(4, MLP_IN)).astype(np.float32)
        jeng = JaxEngine(model_path=path, max_batch=4)
        peng = ServingEngine(model_path=path, max_batch=4, device="cpu")
        try:
            jrec, prec = jeng.registry.get(), peng.registry.get()
            assert prec.precision == jrec.precision == "int8"
            assert prec.quant["verdict"] == jrec.quant["verdict"] == "ok"
            assert type(prec.normalizer).__name__ == "NormalizerStandardize"
            want = np.asarray(jeng.predict(x))
            got = peng.predict(x)
            np.testing.assert_allclose(got, want, atol=1e-5)
            d = prec.describe()
            jd = jrec.describe()
            for k in ("name", "version", "state", "precision", "normalizer"):
                assert d[k] == jd[k], k
        finally:
            jeng.stop()
            peng.stop()

    def test_port_zip_loads_in_jax(self, mlp_pair, tmp_path):
        from deeplearning4j_tpu.utils.serialization import (
            ModelSerializer,
            read_normalizer,
            read_quant,
        )

        jnet, pnet = mlp_pair
        rng = np.random.default_rng(6)
        norm = p_norm.NormalizerMinMaxScaler().fit(
            rng.normal(size=(30, MLP_IN)).astype(np.float32))
        _, ps = _specs(jnet, pnet, _mlp_batches())
        path = str(tmp_path / "port.zip")
        p_ser.write_model(pnet, path, normalizer=norm, quant=ps)
        back = ModelSerializer.restore_multi_layer_network(path)
        x = rng.normal(size=(3, MLP_IN)).astype(np.float32)
        np.testing.assert_allclose(np.asarray(back.output(x)),
                                   pnet.output(x).numpy(), atol=1e-6)
        jn = read_normalizer(path)
        np.testing.assert_allclose(jn.transform_array(x),
                                   norm.transform_array(x), atol=1e-6)
        assert read_quant(path).act_scales == ps.act_scales
