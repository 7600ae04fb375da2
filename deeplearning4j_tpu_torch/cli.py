"""Command line: train, test and predict (counterpart:
``deeplearning4j_tpu/cli.py`` — ``load_xy`` :36, ``load_x``,
``cmd_train``, ``cmd_test``, ``cmd_predict`` and the parser :137-163).

Input formats are sniffed by extension: ``.csv`` (features..., an integer
class label in the last column) or ``.npz`` (arrays ``features`` and, for
train and test, ``labels``; their rank is kept, so an [N, T, F] sequence
set trains a recurrent network with truncated BPTT). The zips ``train``
writes are the interop checkpoint format, which the JAX package's
``ModelSerializer.restore`` reads, and ``test`` and ``predict`` read a zip
of either package. Local files only.

Usage (the network runs on the card):

  python -m deeplearning4j_tpu_torch.cli train   --conf conf.json \\
      --input train.csv --output model.zip [--epochs N] [--batch B]
  python -m deeplearning4j_tpu_torch.cli test    --model model.zip \\
      --input test.csv
  python -m deeplearning4j_tpu_torch.cli predict --model model.zip \\
      --input x.csv [--output preds.csv]

In process, ``main(argv, device=None)`` runs the same commands; tests
pass ``device="cpu"``. The command line keeps the JAX arguments and has
no device flag.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Tuple

import numpy as np


def load_xy(path: str, num_classes: Optional[int] = None
            ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """CSV (features..., label) or NPZ {'features', 'labels'}."""
    if path.endswith(".npz"):
        data = np.load(path)
        x = data["features"].astype(np.float32)
        y = data["labels"].astype(np.float32) if "labels" in data else None
        return x, y
    raw = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    x = raw[:, :-1].astype(np.float32)
    labels = raw[:, -1].astype(np.int64)
    n = num_classes or int(labels.max()) + 1
    y = np.eye(n, dtype=np.float32)[labels]
    return x, y


def load_x(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        return np.load(path)["features"].astype(np.float32)
    return np.loadtxt(path, delimiter=",", dtype=np.float64,
                      ndmin=2).astype(np.float32)


def _build_net_from_conf(conf_path: str, device):
    from deeplearning4j_tpu_torch.nn.conf.graph import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    with open(conf_path, "r", encoding="utf-8") as f:
        text = f.read()
    if "vertices" in json.loads(text):
        return ComputationGraph(ComputationGraphConfiguration.from_json(text),
                                device=device)
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(text),
                             device=device)


def _first_output(out) -> np.ndarray:
    out0 = out[0] if isinstance(out, (list, tuple)) else out
    return out0.detach().to("cpu").numpy()


def cmd_train(args) -> int:
    from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
    from deeplearning4j_tpu_torch.utils.serialization import ModelSerializer

    net = _build_net_from_conf(args.conf, args.device)
    x, y = load_xy(args.input)
    if y is None:
        print("train requires labels (csv last column or npz 'labels')",
              file=sys.stderr)
        return 2
    net.init()
    net.fit_iterator(ListDataSetIterator(x, y, batch=args.batch),
                     num_epochs=args.epochs)
    ModelSerializer.write_model(net, args.output)
    print(f"trained {args.epochs} epoch(s) on {len(x)} examples "
          f"-> {args.output} (final score {net.score_value:.6f})")
    return 0


def _model_num_classes(net) -> Optional[int]:
    conf = net.conf
    if hasattr(conf, "vertices"):  # graph: the first output layer's n_out
        return getattr(conf.vertices[conf.outputs[0]], "n_out", None)
    return getattr(conf.layers[-1], "n_out", None)


def cmd_test(args) -> int:
    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
    from deeplearning4j_tpu_torch.utils.serialization import ModelSerializer

    net = ModelSerializer.restore(args.model, device=args.device)
    # the one-hot width is the model's output size, not the test file's
    # largest label (a split missing the top classes would shrink it)
    x, y = load_xy(args.input, num_classes=_model_num_classes(net))
    if y is None:
        print("test requires labels (csv last column or npz 'labels')",
              file=sys.stderr)
        return 2
    ev = Evaluation()
    ev.eval(y, _first_output(net.output(x)))
    print(ev.stats())
    return 0


def cmd_predict(args) -> int:
    from deeplearning4j_tpu_torch.utils.serialization import ModelSerializer

    net = ModelSerializer.restore(args.model, device=args.device)
    out0 = _first_output(net.output(load_x(args.input)))
    if args.output:
        np.savetxt(args.output, out0, delimiter=",", fmt="%.8g")
        print(f"wrote {out0.shape[0]} predictions -> {args.output}")
    else:
        for row in out0:
            print(",".join(f"{v:.8g}" for v in row))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deeplearning4j-tpu-torch",
        description="train / test / predict (reference CLI parity)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="fit a model from a conf JSON")
    t.add_argument("--conf", required=True, help="MultiLayerConfiguration or "
                   "ComputationGraphConfiguration JSON file")
    t.add_argument("--input", required=True, help="training data (.csv/.npz)")
    t.add_argument("--output", required=True, help="model zip path")
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--batch", type=int, default=32)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("test", help="evaluate a saved model")
    e.add_argument("--model", required=True)
    e.add_argument("--input", required=True)
    e.set_defaults(fn=cmd_test)

    r = sub.add_parser("predict", help="run inference")
    r.add_argument("--model", required=True)
    r.add_argument("--input", required=True)
    r.add_argument("--output", default=None)
    r.set_defaults(fn=cmd_predict)
    return p


def main(argv=None, device=None) -> int:
    """Run one command; the network runs on ``device`` (the card unless
    ``device="cpu"``)."""
    args = build_parser().parse_args(argv)
    args.device = device
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
