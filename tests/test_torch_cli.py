"""The port's command line (``cli.py``) against the JAX package's, on
the CPU.

  * ``train``, ``test`` and ``predict`` through ``main(argv,
    device="cpu")`` on CSV and on NPZ input (the mirror of
    ``tests/test_cli_streaming.py::TestCli``), a rank-3 NPZ training a
    char-RNN with truncated BPTT, and a ComputationGraph conf.
  * Interop: a zip the port's ``train`` wrote is restored by the JAX
    package's ``ModelSerializer.restore``, its ``output`` within 1e-5 of
    the port's; a zip the JAX ``train`` wrote is restored by the port
    within 1e-5; ``predict``'s CSV equals JAX's on the same zip within
    1e-5.
  * Missing labels give exit code 2; the subprocess form raises with no
    card, as the in-process ``main`` without ``device`` does.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference side

from deeplearning4j_tpu.cli import main as jmain  # noqa: E402
from deeplearning4j_tpu.utils.serialization import (  # noqa: E402
    ModelSerializer as JSer,
)
from deeplearning4j_tpu_torch import cli as pcli  # noqa: E402
from deeplearning4j_tpu_torch.utils.serialization import (  # noqa: E402
    ModelSerializer as PSer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def pmain(argv):
    return pcli.main(argv, device="cpu")


def write_conf(path):
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
    )

    conf = (NeuralNetConfiguration.builder().seed(7).learning_rate(0.1)
            .updater("sgd").list()
            .layer(0, DenseLayer(n_in=4, n_out=16, activation="tanh"))
            .layer(1, OutputLayer(n_in=16, n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .build())
    path.write_text(conf.to_json())
    return conf


def write_csv(path, n=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    w = np.random.default_rng(42).normal(size=(4, 3))
    labels = np.argmax(x @ w, axis=1)
    np.savetxt(path, np.column_stack([x, labels]), delimiter=",", fmt="%.6f")
    return x, labels


def x_only(tmp_path, csv):
    out = tmp_path / "x_only.csv"
    np.savetxt(out, np.loadtxt(csv, delimiter=",")[:, :-1], delimiter=",",
               fmt="%.6f")
    return out


class TestCommands:
    def test_train_test_predict_roundtrip(self, tmp_path, capsys):
        conf_path, train_csv = tmp_path / "conf.json", tmp_path / "train.csv"
        model_zip = tmp_path / "model.zip"
        write_conf(conf_path)
        write_csv(train_csv, n=192, seed=0)
        rc = pmain(["train", "--conf", str(conf_path), "--input",
                    str(train_csv), "--output", str(model_zip),
                    "--epochs", "15", "--batch", "32"])
        assert rc == 0 and model_zip.exists()
        assert "final score" in capsys.readouterr().out

        test_csv = tmp_path / "test.csv"
        write_csv(test_csv, n=48, seed=5)
        assert pmain(["test", "--model", str(model_zip), "--input",
                      str(test_csv)]) == 0
        out = capsys.readouterr().out
        assert "Accuracy" in out

        pred_csv = tmp_path / "preds.csv"
        assert pmain(["predict", "--model", str(model_zip), "--input",
                      str(x_only(tmp_path, test_csv)), "--output",
                      str(pred_csv)]) == 0
        preds = np.loadtxt(pred_csv, delimiter=",")
        assert preds.shape == (48, 3)
        np.testing.assert_allclose(preds.sum(axis=1), 1.0, rtol=1e-3)
        # the trained model separates the planted classes
        acc = (preds.argmax(1) == np.loadtxt(test_csv, delimiter=",")[:, -1])
        assert acc.mean() > 0.8

    def test_predict_to_stdout(self, tmp_path, capsys):
        conf_path, train_csv = tmp_path / "conf.json", tmp_path / "t.csv"
        model_zip = tmp_path / "m.zip"
        write_conf(conf_path)
        write_csv(train_csv, n=32)
        pmain(["train", "--conf", str(conf_path), "--input", str(train_csv),
               "--output", str(model_zip)])
        capsys.readouterr()
        assert pmain(["predict", "--model", str(model_zip), "--input",
                      str(x_only(tmp_path, train_csv))]) == 0
        rows = capsys.readouterr().out.strip().splitlines()
        assert len(rows) == 32 and len(rows[0].split(",")) == 3

    def test_npz_input(self, tmp_path):
        conf_path = tmp_path / "conf.json"
        write_conf(conf_path)
        x = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[
            np.random.default_rng(1).integers(0, 3, 64)]
        npz = tmp_path / "data.npz"
        np.savez(npz, features=x, labels=y)
        model_zip = tmp_path / "m.zip"
        assert pmain(["train", "--conf", str(conf_path), "--input",
                      str(npz), "--output", str(model_zip), "--epochs",
                      "1"]) == 0
        assert model_zip.exists()
        assert pmain(["test", "--model", str(model_zip), "--input",
                      str(npz)]) == 0
        np.savez(tmp_path / "x.npz", features=x)
        assert pmain(["predict", "--model", str(model_zip), "--input",
                      str(tmp_path / "x.npz"), "--output",
                      str(tmp_path / "p.csv")]) == 0
        assert np.loadtxt(tmp_path / "p.csv", delimiter=",").shape == (64, 3)

    def test_missing_labels(self, tmp_path, capsys):
        conf_path = tmp_path / "conf.json"
        write_conf(conf_path)
        np.savez(tmp_path / "x.npz",
                 features=np.zeros((4, 4), np.float32))
        assert pmain(["train", "--conf", str(conf_path), "--input",
                      str(tmp_path / "x.npz"), "--output",
                      str(tmp_path / "m.zip")]) == 2
        assert "requires labels" in capsys.readouterr().err

    def test_rank3_npz_trains_a_char_rnn(self, tmp_path):
        from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_conf
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        conf = char_rnn_conf(12, lstm_size=8, num_layers=2, seed=3,
                             tbptt_length=4)
        (tmp_path / "c.json").write_text(conf.to_json())
        rng = np.random.default_rng(0)
        eye = np.eye(12, dtype=np.float32)
        ids = rng.integers(0, 12, (16, 9))
        np.savez(tmp_path / "seq.npz", features=eye[ids[:, :-1]],
                 labels=eye[ids[:, 1:]])
        model_zip = tmp_path / "m.zip"
        assert pmain(["train", "--conf", str(tmp_path / "c.json"),
                      "--input", str(tmp_path / "seq.npz"), "--output",
                      str(model_zip), "--batch", "4"]) == 0
        net = MultiLayerNetwork.load(str(model_zip), device="cpu")
        # 4 batches of 8 steps at TBPTT 4: two windows a fit
        assert net.iteration == 8

    def test_graph_conf(self, tmp_path):
        from deeplearning4j_tpu_torch.nn import conf as pconf

        conf = (pconf.NeuralNetConfiguration.builder().seed(1)
                .learning_rate(0.1).graph_builder().add_inputs("in")
                .add_layer("d", pconf.DenseLayer(n_in=4, n_out=6,
                                                 activation="tanh"), "in")
                .add_layer("out", pconf.OutputLayer(n_in=6, n_out=3), "d")
                .set_outputs("out").build())
        (tmp_path / "g.json").write_text(conf.to_json())
        write_csv(tmp_path / "t.csv", n=32)
        assert pmain(["train", "--conf", str(tmp_path / "g.json"),
                      "--input", str(tmp_path / "t.csv"), "--output",
                      str(tmp_path / "g.zip")]) == 0
        assert pmain(["test", "--model", str(tmp_path / "g.zip"),
                      "--input", str(tmp_path / "t.csv")]) == 0
        assert pmain(["predict", "--model", str(tmp_path / "g.zip"),
                      "--input", str(x_only(tmp_path, tmp_path / "t.csv")),
                      "--output", str(tmp_path / "p.csv")]) == 0


@pytest.fixture()
def trained(tmp_path):
    conf_path, train_csv = tmp_path / "conf.json", tmp_path / "train.csv"
    write_conf(conf_path)
    write_csv(train_csv, n=96, seed=0)
    return conf_path, train_csv, x_only(tmp_path, train_csv)


class TestInterop:
    def test_port_zip_restores_in_jax(self, tmp_path, trained):
        conf_path, train_csv, xs = trained
        model_zip = tmp_path / "port.zip"
        assert pmain(["train", "--conf", str(conf_path), "--input",
                      str(train_csv), "--output", str(model_zip),
                      "--epochs", "3"]) == 0
        x = np.loadtxt(xs, delimiter=",").astype(np.float32)
        jnet = JSer.restore(str(model_zip))
        pnet = PSer.restore(str(model_zip), device="cpu")
        np.testing.assert_allclose(np.asarray(jnet.output(x)),
                                   pnet.output(x).numpy(), atol=TOL)

    def test_jax_zip_restores_in_the_port(self, tmp_path, trained):
        conf_path, train_csv, xs = trained
        model_zip = tmp_path / "jax.zip"
        assert jmain(["train", "--conf", str(conf_path), "--input",
                      str(train_csv), "--output", str(model_zip),
                      "--epochs", "3"]) == 0
        x = np.loadtxt(xs, delimiter=",").astype(np.float32)
        pnet = PSer.restore(str(model_zip), device="cpu")
        jnet = JSer.restore(str(model_zip))
        np.testing.assert_allclose(pnet.output(x).numpy(),
                                   np.asarray(jnet.output(x)), atol=TOL)
        assert pnet.iteration == jnet.iteration

    def test_predict_csv_equals_jax(self, tmp_path, trained):
        conf_path, train_csv, xs = trained
        model_zip = tmp_path / "m.zip"
        jmain(["train", "--conf", str(conf_path), "--input", str(train_csv),
               "--output", str(model_zip)])
        jp, pp = tmp_path / "j.csv", tmp_path / "p.csv"
        assert jmain(["predict", "--model", str(model_zip), "--input",
                      str(xs), "--output", str(jp)]) == 0
        assert pmain(["predict", "--model", str(model_zip), "--input",
                      str(xs), "--output", str(pp)]) == 0
        jt, pt = jp.read_text().splitlines(), pp.read_text().splitlines()
        assert len(jt) == len(pt) == 96
        np.testing.assert_allclose(np.loadtxt(pp, delimiter=","),
                                   np.loadtxt(jp, delimiter=","), atol=TOL)

    def test_test_command_prints_jax_stats(self, tmp_path, trained, capsys):
        conf_path, train_csv, _ = trained
        model_zip = tmp_path / "m.zip"
        jmain(["train", "--conf", str(conf_path), "--input", str(train_csv),
               "--output", str(model_zip)])
        capsys.readouterr()
        jmain(["test", "--model", str(model_zip), "--input", str(train_csv)])
        want = capsys.readouterr().out
        pmain(["test", "--model", str(model_zip), "--input", str(train_csv)])
        assert capsys.readouterr().out == want


class TestNoCard:
    def test_main_without_device_raises(self, tmp_path, trained,
                                        monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        conf_path, train_csv, _ = trained
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pcli.main(["train", "--conf", str(conf_path), "--input",
                       str(train_csv), "--output", str(tmp_path / "m.zip")])

    def test_subprocess_raises_without_a_card(self, tmp_path, trained):
        conf_path, train_csv, _ = trained
        env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
        r = subprocess.run(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "train",
             "--conf", str(conf_path), "--input", str(train_csv),
             "--output", str(tmp_path / "m.zip")],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert "device='cpu'" in r.stderr
        assert not (tmp_path / "m.zip").exists()

    def test_parser_keeps_the_jax_arguments(self):
        from deeplearning4j_tpu.cli import build_parser as jparser

        def shape(p):
            sub = next(a for a in p._actions
                       if a.__class__.__name__ == "_SubParsersAction")
            return {name: sorted((tuple(a.option_strings), a.default,
                                  a.required)
                                 for a in sp._actions
                                 if a.option_strings != ["-h", "--help"])
                    for name, sp in sub.choices.items()}

        assert shape(pcli.build_parser()) == shape(jparser())

    def test_load_xy_keeps_the_rank(self, tmp_path):
        x = np.zeros((3, 5, 2), np.float32)
        np.savez(tmp_path / "s.npz", features=x, labels=x)
        px, py = pcli.load_xy(str(tmp_path / "s.npz"))
        from deeplearning4j_tpu.cli import load_xy as jload

        jx, jy = jload(str(tmp_path / "s.npz"))
        assert px.shape == jx.shape == (3, 5, 2) and np.array_equal(py, jy)
