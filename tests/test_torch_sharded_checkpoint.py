"""The port's sharded checkpoint (``utils/sharded_checkpoint.py``) and the
checkpoint manager's ``backend="sharded"``, in one process, case by case
after the JAX package's ``tests/test_sharded_checkpoint.py``: tree round
trips (dicts, lists, non-tensor leaves, each leaf's dtype kept), a
TransformerLM's save and resume (the next step bit-equal to the model it
came from, dense and MoE), a weights-only restore, an overwrite committed
by the pointer flip with the old version pruned, a version the pointer
does not name invisible, and the manager's sharded checkpoints of an MLN
(restore_latest bit-equal, a corrupted shard file skipped for the older
checkpoint). Restores onto other meshes (TP 2 onto one device, pipe 2 x
data 2 onto data 2 x model 2) run in the gloo spawns of
``test_torch_moe.py`` and ``test_torch_model_parallel.py``.
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves
from deeplearning4j_tpu_torch.utils import sharded_checkpoint as sc

LM_KW = dict(vocab_size=50, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_len=16, learning_rate=1e-3, use_flash=False)


def _batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 50, (n, 17))
    return ids[:, :-1], ids[:, 1:]


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def test_plain_pytree(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(2, dtype=torch.float64),
                  {"c": torch.zeros(3, dtype=torch.bfloat16)}],
            "n": 7}
    path = str(tmp_path / "tree")
    sc.save_pytree(path, tree)
    back = sc.restore_pytree(path, tree, device="cpu")
    _equal_trees(back, tree)
    assert back["n"] == 7
    plain = sc.restore_pytree(path, device="cpu")  # structure from paths
    assert torch.equal(plain["b"]["1"]["c"], tree["b"][1]["c"])


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_save_restore_resume_identical(tmp_path, moe):
    cfg = pt.TransformerConfig(**dict(LM_KW, **(
        {"moe_experts": 4, "d_ff": 32} if moe else {})))
    lm = pt.TransformerLM(cfg, device="cpu")
    x, y = _batch()
    lm.fit(x, y)
    sc.save_lm(str(tmp_path / "ck"), lm)
    back = sc.restore_lm(str(tmp_path / "ck"), device="cpu")
    assert back.iteration == lm.iteration == 1
    _equal_trees(back.params, lm.params)
    _equal_trees(back.opt, lm.opt)
    assert torch.equal(back.logits(x), lm.logits(x))
    x2, y2 = _batch(1)
    assert torch.equal(back.fit(x2, y2), lm.fit(x2, y2))
    _equal_trees(back.params, lm.params)


def test_weights_only_restore(tmp_path):
    lm = pt.TransformerLM(pt.TransformerConfig(**LM_KW), device="cpu")
    lm.fit(*_batch())
    sc.save_lm(str(tmp_path / "ck"), lm)
    back = sc.restore_lm(str(tmp_path / "ck"), load_updater=False,
                         device="cpu")
    _equal_trees(back.params, lm.params)
    assert back.iteration == 0
    assert float(back.opt["m"]["embed"].abs().max()) == 0.0


def test_overwrite_is_atomic_and_repeatable(tmp_path):
    path = str(tmp_path / "t")
    for i in range(3):
        sc.save_pytree(path, {"w": torch.full((4,), float(i))})
        got = sc.restore_pytree(path, device="cpu")
        assert torch.equal(got["w"], torch.full((4,), float(i)))
    versions = sorted(p for p in os.listdir(tmp_path) if ".v" in p
                      and not p.endswith(".current"))
    assert versions == ["t.v3"]
    with open(path + ".current") as f:
        assert f.read().strip() == "t.v3"


def test_pointer_commit_and_prune(tmp_path):
    path = str(tmp_path / "p")
    sc.save_pytree(path, {"w": torch.zeros(2)})
    assert os.path.isdir(path + ".v1")
    sc.save_pytree(path, {"w": torch.ones(2)})
    assert not os.path.exists(path + ".v1") and os.path.isdir(path + ".v2")
    assert sc._resolve(path).endswith("p.v2")


def test_uncommitted_version_is_invisible(tmp_path):
    path = str(tmp_path / "u")
    sc.save_pytree(path, {"w": torch.zeros(2)})
    # a later version written but never committed (a crash before the
    # pointer flip): the reader still sees v1
    os.makedirs(path + ".v2/item")
    torch.save({"w": torch.ones(2)}, path + ".v2/item/shard-00000.pt")
    assert torch.equal(sc.restore_pytree(path, device="cpu")["w"],
                       torch.zeros(2))
    with pytest.raises(FileNotFoundError):
        sc.restore_pytree(str(tmp_path / "never"), device="cpu")


def _mln(seed=5):
    from deeplearning4j_tpu_torch.nn import conf as pconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (pconf.NeuralNetConfiguration.builder().seed(seed)
            .learning_rate(0.1).updater("adam").list()
            .layer(0, pconf.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(1, pconf.BatchNormalization(n_in=8, n_out=8))
            .layer(2, pconf.OutputLayer(n_in=8, n_out=3,
                                        activation="softmax"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_manager_sharded_backend(tmp_path):
    """Two sharded checkpoints of an MLN with BN (params, states and Adam
    state); restore_latest is bit-equal and resumes bit-equal; a corrupt
    shard file of the newest falls back to the older."""
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
    )

    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    net = _mln()
    mgr = CheckpointManager(str(tmp_path / "ck"), backend="sharded",
                            async_save=False, keep_last=3)
    net.fit(x, y)
    mgr.save(net, step=1)
    net.fit(x, y)
    path = mgr.save(net, step=2)
    manifest = mgr.read_manifest(path)
    assert manifest["backend"] == "sharded"
    assert any(f.endswith(".pt") for f in manifest["files"])
    back = _mln()
    info = mgr.restore_latest(back)
    assert info["step"] == 2 and back.iteration == net.iteration
    _equal_trees(back.params, net.params)
    _equal_trees(back.states, net.states)
    _equal_trees(back.updater_state, net.updater_state)
    assert torch.equal(back.fit(x, y), net.fit(x, y))
    _equal_trees(back.params, net.params)
    shard = next(os.path.join(r, f) for r, _, fs in os.walk(path)
                 for f in fs if f.endswith(".pt"))
    with open(shard, "r+b") as f:
        f.seek(40)
        f.write(b"\xff\xff\xff\xff")
    older = _mln()
    assert mgr.restore_latest(older)["step"] == 1
    mgr.close()
