"""ResNet-50 and GoogLeNet on the port's ComputationGraph against the JAX
package's, on the CPU.

  * At 224 x 224 x 3 and 1000 classes the port's builders write the JAX
    package's conf JSON and initialize its parameter count, vertex by
    vertex and leaf by leaf in shape (JAX's by ``jax.eval_shape``: no
    allocation); GoogLeNet with its two auxiliary heads has three outputs,
    the main one first.
  * One f64 step at full width and a small input (ResNet-50 at 64,
    GoogLeNet with its aux heads at 32; dropout off, as the two packages
    draw other bits): the loss at 1e-10, every param, BN state and
    Nesterovs leaf at 1e-9, and ``output`` after it, all three heads.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.models import googlenet as pgoog  # noqa: E402
from deeplearning4j_tpu_torch.models import resnet as pres  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.graph import (  # noqa: E402
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.ops.lowprec import tree_map  # noqa: E402

from test_torch_graph import _host, _jgraph, max_diff  # noqa: E402

TOL = 1e-10


def _confs(which, **kw):
    from deeplearning4j_tpu.models import googlenet as jgoog
    from deeplearning4j_tpu.models import resnet as jres

    if which == "resnet50":
        return jres.resnet50_conf(**kw), pres.resnet50_conf(**kw)
    return (jgoog.googlenet_conf(aux_heads=True, **kw),
            pgoog.googlenet_conf(aux_heads=True, **kw))


@pytest.mark.parametrize("which,count", [("resnet50", 25_583_592),
                                         ("googlenet", 13_378_280)])
def test_full_size_conf_and_params(which, count):
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

    jconf, pconf_ = _confs(which)
    assert pconf_.to_json() == jconf.to_json()
    shapes = {"in": (224, 224, 3)}

    def init():
        return JGraph(jconf).init(shapes).params

    jshapes = jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                     jax.eval_shape(init))
    build = pres.build_resnet50 if which == "resnet50" else (
        lambda device: pgoog.build_googlenet(aux_heads=True, device=device))
    pnet = build(device="cpu")
    assert tree_map(lambda a: tuple(a.shape), pnet.params) == jshapes
    jcount = sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
        jshapes, is_leaf=lambda v: isinstance(v, tuple)))
    assert pnet.num_params() == jcount == count
    if which == "googlenet":
        assert pnet.conf.outputs == ["out", "aux1", "aux2"]


def _no_dropout(conf):
    for v in conf.vertices.values():
        if getattr(v, "dropout", None):
            v.dropout = 0.0
    return conf


@pytest.mark.parametrize("which,size", [("resnet50", 64), ("googlenet", 32)])
def test_one_f64_step_at_full_width(which, size):
    jconf, _ = _confs(which, input_size=size, num_classes=10)
    jnet = _jgraph(_no_dropout(jconf), {"in": (size, size, 3)})
    pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init({"in": (size, size, 3)})
    pnet.params, pnet.states = _host(jnet.params), _host(jnet.states)
    pnet.updater_state = _host(jnet.updater_state)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, size, size, 3))
    y = np.eye(10)[rng.integers(0, 10, 2)]
    labels = [y] * len(jnet.conf.outputs)
    jl = float(jnet.fit(jnp.asarray(x), [jnp.asarray(v) for v in labels]))
    pl = float(pnet.fit(x, labels))
    assert abs(jl - pl) < TOL
    assert max_diff(pnet.params, jnet.params) < 1e-9
    assert max_diff(pnet.states, jnet.states) < 1e-9
    assert max_diff(pnet.updater_state, jnet.updater_state) < 1e-9
    pouts = pnet.output(x)
    jouts = jnet.output(jnp.asarray(x))
    assert len(pouts) == len(jouts) == len(jnet.conf.outputs)
    for p, j in zip(pouts, jouts):
        assert max_diff(p, j) < TOL
