"""The port's CNN layers and CNN networks against the JAX package, on the
CPU.

Inputs and cotangents come from a numpy seed; params are the JAX layer's
or network's init, carried over by value (``params_from_numpy`` for
networks). Comparisons are in f64 (x64 is on in ``tests/conftest.py``) at
1e-10 abs unless they say otherwise.

  * Layers, forward and the gradient of <y, g> with respect to the params
    and the input: convolution with stride and padding; max, avg and sum
    pooling, with a padding inside half the window and one past it (the
    port pads by ``F.pad`` there); BatchNormalization in training (the
    batch statistics and the new running state, biased variance) and in
    inference (the running state), on dense and NHWC input, and with
    ``lock_gamma_beta``; LRN.
  * LeNet-5 (``build_lenet5``'s conf): three ``fit``s, then
    ``fit_batches`` of K=2, loss by loss and every param and Nesterovs
    leaf after.
  * AlexNet at input 67 and VGG16 at input 32: one step in f64 (dropout
    off: the two packages draw other bits); their 227 and 224 parameter
    counts equal the JAX package's; their conf JSON is the JAX string.
  * ``_synthetic_mnist`` is bit-equal to the JAX package's and
    ``MnistDataSetIterator`` reads local idx files (plain and gzip) under
    ``DL4J_TPU_DATA_DIR``.
  * Zips both ways: the JAX package's LeNet-5 zip loads in the port and
    the port's in the JAX package; ``output`` in f32 within 1e-5.
  * ``evaluate`` and ``clone``.
"""

import dataclasses
import gzip
import struct

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.datasets import fetchers as pfetch  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator  # noqa: E402
from deeplearning4j_tpu_torch.models import alexnet as palex  # noqa: E402
from deeplearning4j_tpu_torch.models import lenet as plenet  # noqa: E402
from deeplearning4j_tpu_torch.models import vgg as pvgg  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as pconf  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers import factory as pfactory  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
    params_from_numpy,
)
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves, tree_map  # noqa: E402
from deeplearning4j_tpu_torch.utils import serialization as pser  # noqa: E402

TOL = 1e-10
TOL_F32 = 1e-5


# ---------------------------------------------------------------------------
# helpers shared with tests/test_torch_layer_zoo.py
# ---------------------------------------------------------------------------


def layer_pair(jconf_obj, input_shape, seed=1, perturb=("b",)):
    """(JAX layer, its f64 params and state as jnp, the port's layer, the
    same params and state as torch). Leaves named in ``perturb`` get a
    seeded offset so every term is exercised."""
    from deeplearning4j_tpu.nn.conf.layers import resolve
    from deeplearning4j_tpu.nn.layers.factory import create_layer

    jconf_obj = resolve(jconf_obj)
    jl = create_layer(jconf_obj)
    params, state, _ = jl.initialize(jax.random.PRNGKey(seed), input_shape)
    rng = np.random.default_rng(seed + 100)

    def host(tree):
        def leaf(path, a):
            a = np.asarray(a, np.float64)
            name = path[-1].key
            if name in perturb:
                a = a + rng.normal(0, 0.3, a.shape)
            return a

        return jax.tree_util.tree_map_with_path(leaf, tree)

    np_params, np_state = host(params), host(state)
    pl = pfactory.create_layer(pconf.layer_from_dict(
        dataclasses.asdict(jconf_obj) | {"type": type(jconf_obj).__name__}))
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    to_p = lambda t: jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), t)
    return jl, to_j(np_params), to_j(np_state), pl, to_p(np_params), \
        to_p(np_state)


def forward_and_grads(jl, jp, js, pl, pp, ps, x, *, train=False, mask=None,
                      seed=0):
    """Each package's forward, new state and gradient of <y, g> with
    respect to (params, x), as numpy trees."""
    jx = jnp.asarray(x)
    jm = None if mask is None else jnp.asarray(mask)
    jy, jst = jl.apply(jp, js, jx, train=train, mask=jm)
    g = np.random.default_rng(seed).normal(size=np.shape(jy))

    def jloss(p, xx):
        return jnp.sum(jl.apply(p, js, xx, train=train, mask=jm)[0] * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    tp = tree_map(lambda a: a.clone().requires_grad_(True), pp)
    tx = torch.from_numpy(np.array(x)).requires_grad_(True)
    tm = None if mask is None else torch.from_numpy(np.array(mask))
    ty, tst = pl.apply(tp, ps, tx, train=train, mask=tm)
    leaves = tree_leaves(tp)
    grads = torch.autograd.grad((ty * torch.from_numpy(g)).sum(),
                                leaves + [tx], allow_unused=True,
                                materialize_grads=True)
    it = iter(grads[:-1])
    tgp = tree_map(lambda a: next(it), tp)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    thost = lambda t: tree_map(lambda a: a.detach().numpy(), t)
    return ((np.asarray(jy), host(jst), host(jgp), np.asarray(jgx)),
            (ty.detach().numpy(), thost(tst), thost(tgp),
             grads[-1].numpy()))


def max_diff(a, b) -> float:
    """Largest abs difference over two trees of the same structure."""
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        return max([max_diff(a[k], b[k]) for k in a] or [0.0])
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if not a.size:
        return 0.0
    return float(np.where(a == b, 0.0, np.abs(a - b)).max())


def assert_layer_matches(jl, jp, js, pl, pp, ps, x, tol=TOL, **kw):
    want, got = forward_and_grads(jl, jp, js, pl, pp, ps, x, **kw)
    for what, w, g in zip(("y", "state", "param grads", "x grad"),
                          want, got):
        assert max_diff(w, g) < tol, what


def jax_net_f64(jnet):
    jnet.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), jnet.params)
    jnet.states = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), jnet.states)
    jnet.updater_state = jnet.updater.init(jnet.params)
    return jnet


def port_twin(jnet, dtype=np.float64):
    """The port's network of the JAX net's configuration with its params,
    states and a fresh updater state, in ``dtype``, on the CPU."""
    pnet = MultiLayerNetwork(
        pconf.MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device="cpu")
    pnet.init(jnet._input_shape)
    to = lambda t: tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype)),
        jax.tree_util.tree_map(np.asarray, t))
    pnet.params, pnet.states = to(jnet.params), to(jnet.states)
    pnet.updater_state = pnet.updater.init(pnet.params)
    return pnet


def assert_nets_match(jnet, pnet, tol=TOL):
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    thost = lambda t: tree_map(lambda a: a.detach().numpy(), t)
    for jl_, pl_ in zip(host(jnet.params), thost(pnet.params)):
        assert max_diff(jl_, pl_) < tol
    for jl_, pl_ in zip(host(jnet.states), thost(pnet.states)):
        assert max_diff(jl_, pl_) < tol
    for jl_, pl_ in zip(host(jnet.updater_state), thost(pnet.updater_state)):
        assert max_diff(jl_, pl_) < tol


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class TestCnnLayersAgainstJax:
    @pytest.mark.parametrize("stride,padding,act", [
        ((1, 1), (0, 0), "identity"), ((2, 3), (1, 2), "relu"),
        ((3, 1), (2, 0), "tanh")])
    def test_convolution(self, stride, padding, act):
        from deeplearning4j_tpu.nn.conf.layers import ConvolutionLayer

        pair = layer_pair(ConvolutionLayer(
            n_in=3, n_out=5, kernel_size=(3, 2), stride=stride,
            padding=padding, activation=act), (9, 8, 3))
        x = np.random.default_rng(0).normal(size=(2, 9, 8, 3))
        assert_layer_matches(*pair, x)

    @pytest.mark.parametrize("pooling", ["max", "avg", "sum"])
    @pytest.mark.parametrize("kernel,stride,padding", [
        ((2, 2), (2, 2), (0, 0)), ((3, 3), (2, 1), (1, 1)),
        ((3, 2), (1, 2), (2, 1)),     # past half the window: F.pad first
        ((2, 3), (2, 2), (1, 2))])
    def test_pooling(self, pooling, kernel, stride, padding):
        from deeplearning4j_tpu.nn.conf.layers import SubsamplingLayer

        pair = layer_pair(SubsamplingLayer(
            pooling_type=pooling, kernel_size=kernel, stride=stride,
            padding=padding), (7, 8, 3))
        x = np.random.default_rng(1).normal(size=(2, 7, 8, 3))
        assert_layer_matches(*pair, x)

    @pytest.mark.parametrize("train", [True, False])
    @pytest.mark.parametrize("shape", [(6,), (5, 4, 3)])
    @pytest.mark.parametrize("locked", [False, True])
    def test_batch_normalization(self, train, shape, locked):
        from deeplearning4j_tpu.nn.conf.layers import BatchNormalization

        pair = layer_pair(BatchNormalization(
            n_out=shape[-1], decay=0.8, lock_gamma_beta=locked,
            gamma=1.5, beta=0.25), shape,
            perturb=("gamma", "beta", "mean", "var"))
        js = pair[2]
        # a positive running variance after the perturbation
        pair = pair[:2] + ({"mean": js["mean"], "var": jnp.abs(js["var"])
                            + 0.1},) + pair[3:5] + (
            {"mean": pair[5]["mean"],
             "var": torch.abs(pair[5]["var"]) + 0.1},)
        x = np.random.default_rng(2).normal(2.0, 3.0, size=(4,) + shape)
        assert_layer_matches(*pair, x, train=train)

    @pytest.mark.parametrize("n,k,alpha,beta", [(5.0, 2.0, 1e-4, 0.75),
                                                (4.0, 1.0, 0.1, 0.5),
                                                (3.0, 2.0, 0.3, 1.0)])
    def test_local_response_normalization(self, n, k, alpha, beta):
        from deeplearning4j_tpu.nn.conf.layers import (
            LocalResponseNormalization,
        )

        pair = layer_pair(LocalResponseNormalization(n=n, k=k, alpha=alpha,
                                                     beta=beta), (4, 3, 7))
        x = np.random.default_rng(3).normal(size=(2, 4, 3, 7)) * 3
        assert_layer_matches(*pair, x)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------


def _mnist_like(seed, n):
    from deeplearning4j_tpu.datasets.fetchers import _synthetic_mnist

    imgs, lbls = _synthetic_mnist(n, seed)
    x = (imgs.astype(np.float64) / 255.0).reshape(n, 28, 28, 1)
    return x, np.eye(10)[lbls.astype(np.int64)]


class TestLenet5AgainstJax:
    def test_three_fits_then_fit_batches(self):
        from deeplearning4j_tpu.models.lenet import build_lenet5

        jnet = jax_net_f64(build_lenet5())
        pnet = port_twin(jnet)
        x, y = _mnist_like(0, 48)
        for k in range(3):
            sl = slice(8 * k, 8 * (k + 1))
            jl = float(jnet.fit(jnp.asarray(x[sl]), jnp.asarray(y[sl])))
            pl = float(pnet.fit(x[sl], y[sl]))
            assert abs(jl - pl) < TOL
        assert_nets_match(jnet, pnet)
        xs, ys = x[24:40].reshape(2, 8, 28, 28, 1), y[24:40].reshape(2, 8, 10)
        jl = np.asarray(jnet.fit_batches(jnp.asarray(xs), jnp.asarray(ys)))
        pl = pnet.fit_batches(xs, ys)
        assert pl.shape == (2,) and np.abs(jl - pl).max() < TOL
        assert jnet.iteration == pnet.iteration == 5
        assert_nets_match(jnet, pnet)
        np.testing.assert_allclose(
            pnet.output(x[40:]).numpy(),
            np.asarray(jnet.output(jnp.asarray(x[40:]))), rtol=0, atol=TOL)


@pytest.mark.parametrize("which,size,n", [("alexnet", 67, 2),
                                          ("vgg16", 32, 2)])
def test_flagship_cnn_one_step_in_f64(which, size, n):
    """One fit of the full-width stack at a small input (dropout off, 10
    classes), loss and every param and Nesterovs leaf."""
    from deeplearning4j_tpu.models.alexnet import build_alexnet
    from deeplearning4j_tpu.models.vgg import build_vgg16

    build = build_alexnet if which == "alexnet" else build_vgg16
    jnet = jax_net_f64(build(input_size=size, num_classes=10, dropout=0.0))
    pnet = port_twin(jnet)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, size, size, 3))
    y = np.eye(10)[rng.integers(0, 10, n)]
    jl = float(jnet.fit(jnp.asarray(x), jnp.asarray(y)))
    pl = float(pnet.fit(x, y))
    assert abs(jl - pl) < TOL
    assert_nets_match(jnet, pnet)


@pytest.mark.parametrize("which", ["alexnet", "vgg16"])
def test_flagship_cnn_full_size_params_and_conf(which):
    """At 227 (AlexNet) and 224 (VGG16) the port initializes the JAX
    package's parameter count, leaf by leaf in shape, and its conf JSON is
    the JAX string. The nets are dropped before the next."""
    from deeplearning4j_tpu.models import alexnet as jalex
    from deeplearning4j_tpu.models import vgg as jvgg
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    if which == "alexnet":
        jconf, pconf_, size = jalex.alexnet_conf(), palex.alexnet_conf(), 227
        pbuild = palex.build_alexnet
    else:
        jconf, pconf_, size = jvgg.vgg16_conf(), pvgg.vgg16_conf(), 224
        pbuild = pvgg.build_vgg16
    assert pconf_.to_json() == jconf.to_json()
    jnet = JNet(jconf)
    jshapes = []
    shape = (size, size, 3)
    for i, layer in enumerate(jnet.layers):  # shapes only: no allocation
        pp = jconf.input_preprocessors.get(i)
        if pp is not None:
            shape = pp.out_shape(shape)
        out = {}

        def init(key, shape=shape, layer=layer, out=out):
            p, _, out["shape"] = layer.initialize(key, shape)
            return p

        jshapes.append(jax.tree_util.tree_map(
            lambda s: tuple(s.shape),
            jax.eval_shape(init, jax.random.PRNGKey(0))))
        shape = out["shape"]
    pnet = pbuild(device="cpu")
    pshapes = [tree_map(lambda a: tuple(a.shape), p) for p in pnet.params]
    assert pshapes == jshapes
    count = sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
        jshapes, is_leaf=lambda v: isinstance(v, tuple)))
    assert pnet.num_params() == count
    assert count == (62_378_344 if which == "alexnet" else 138_357_544)


# ---------------------------------------------------------------------------
# MNIST
# ---------------------------------------------------------------------------


def test_synthetic_mnist_is_bit_equal_to_jax():
    from deeplearning4j_tpu.datasets import fetchers as jfetch

    for n, seed in ((7, 123), (512, 0)):
        ji, jl_ = jfetch._synthetic_mnist(n, seed)
        pi, pl = pfetch._synthetic_mnist(n, seed)
        np.testing.assert_array_equal(ji, pi)
        np.testing.assert_array_equal(jl_, pl)


def test_mnist_reads_local_idx_files(tmp_path, monkeypatch):
    """Local idx files under DL4J_TPU_DATA_DIR (gzip under MNIST/) win
    over the stand-in; without them the provenance says synthetic."""
    from deeplearning4j_tpu.datasets import fetchers as jfetch

    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "empty"))
    x, y, prov = pfetch.load_mnist_info(num_examples=5)
    jx, jy, _ = jfetch.load_mnist_info(num_examples=5, download=False)
    assert prov == "synthetic" and x.shape == (5, 28, 28, 1)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    imgs, lbls = pfetch._synthetic_mnist(6, 9)
    d = tmp_path / "data" / "MNIST"
    d.mkdir(parents=True)
    with gzip.open(d / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 6, 28, 28) + imgs.tobytes())
    with gzip.open(d / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 6) + lbls.tobytes())
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "data"))
    x, y, prov = pfetch.load_mnist_info(binarize=True)
    assert prov == "local" and x.shape == (6, 28, 28, 1)
    np.testing.assert_array_equal(
        x[..., 0], (imgs.astype(np.float32) / 255.0 > 0.5))
    np.testing.assert_array_equal(y.argmax(1), lbls)
    it = pfetch.MnistDataSetIterator(4, 6, flatten=True)
    assert [ds.features.shape for ds in it] == [(4, 784), (2, 784)]


# ---------------------------------------------------------------------------
# checkpoints, evaluate, clone
# ---------------------------------------------------------------------------


class TestLenetZipsBothWays:
    def test_jax_zip_loads_in_the_port(self, tmp_path):
        from deeplearning4j_tpu.models.lenet import build_lenet5
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        jnet = build_lenet5()
        x, y = _mnist_like(1, 16)
        jnet.fit(jnp.asarray(x[:8], jnp.float32), jnp.asarray(y[:8]))
        path = str(tmp_path / "lenet.zip")
        ModelSerializer.write_model(jnet, path)
        pnet = MultiLayerNetwork.load(path, device="cpu")
        assert pnet.iteration == 1 and pnet._input_shape == (28, 28, 1)
        got = pnet.output(x[8:].astype(np.float32)).numpy()
        want = np.asarray(jnet.output(jnp.asarray(x[8:], jnp.float32)))
        assert np.abs(got - want).max() < TOL_F32

    def test_port_zip_loads_in_jax(self, tmp_path):
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        pnet = plenet.build_lenet5(device="cpu")
        x, y = _mnist_like(2, 16)
        x, y = x.astype(np.float32), y.astype(np.float32)
        pnet.fit(x[:8], y[:8])
        path = str(tmp_path / "lenet_port.zip")
        pser.write_model(pnet, path)
        jnet = ModelSerializer.restore_multi_layer_network(path)
        assert jnet.iteration == 1
        want = pnet.output(x[8:]).numpy()
        got = np.asarray(jnet.output(jnp.asarray(x[8:])))
        assert np.abs(got - want).max() < TOL_F32
        np.testing.assert_array_equal(
            np.asarray(jnet.updater_state[0]["v"]["W"]),
            pnet.updater_state[0]["v"]["W"].numpy())


def test_evaluate_and_clone():
    """``evaluate`` gives the JAX package's Evaluation on the same
    outputs; a clone owns copies: training the original moves none of its
    tensors."""
    from deeplearning4j_tpu.models.lenet import build_lenet5

    jnet = build_lenet5()
    pnet = port_twin(jnet, np.float32)
    x, y = _mnist_like(3, 20)
    x, y = x.astype(np.float32), y.astype(np.float32)
    pev = pnet.evaluate(ListDataSetIterator(x, y, batch=8))
    from deeplearning4j_tpu.datasets.iterator import (
        ListDataSetIterator as JList,
    )

    jev = jnet.evaluate(JList(x, y, batch=8))
    np.testing.assert_array_equal(pev.confusion.matrix,
                                  jev.confusion.matrix)
    assert pev.stats() == jev.stats()
    twin = pnet.clone()
    before = [t.clone() for t in tree_leaves(twin.params)]
    pnet.fit(x[:8], y[:8])
    assert twin.iteration == 0 and pnet.iteration == 1
    for a, b in zip(before, tree_leaves(twin.params)):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(twin.params), tree_leaves(pnet.params)))
    assert twin.conf is not pnet.conf
    assert twin.conf.to_json() == pnet.conf.to_json()


def test_params_from_numpy_keeps_nesting():
    tree = [{"fwd": {"W": np.ones((2, 3))}, "b": np.zeros(3)}, {}]
    out = params_from_numpy(tree, device="cpu")
    assert out[0]["fwd"]["W"].dtype == torch.float32
    assert out[1] == {}
