"""The port's spatial trees, t-SNE and filter renders against the JAX
package's, on the CPU.

  * The trees: ``KDTree`` (balanced build and inserts: nn, kNN, range),
    ``VPTree`` (euclidean and cosine kNN, ``words_nearest``, ties in a
    grid of equal distances), ``SPTree`` and ``QuadTree`` (Barnes-Hut
    forces and sums of Q, duplicate points): results equal to JAX's.
  * ``tsne_step`` against the JAX ``_tsne_step`` for 20 steps in f64 at
    1e-10 (Y, velocity, gains and the KL of each step), through the
    exaggeration and momentum switches.
  * A whole exact ``Tsne.fit_transform`` in f64 (both modules' host
    arrays lifted) at 1e-10 with its ``kl_history``; ``_input_p`` and
    ``_binary_search_betas`` equal; the default f32 fit separates three
    blobs (in f32 the two packages' fits part after ~40 steps: t-SNE
    amplifies summation-order roundoff).
  * ``BarnesHutTsne``: Y at 1e-10 after 30 iterations, and its KL history.
  * ``PlotFilters`` (2-D and 4-D inputs, spacing), ``reconstruct``
    through AutoEncoder and RBM layers of a port network carrying the JAX
    network's weights, ``ReconstructionRender``, the listener and the PNG
    round trip, against JAX's arrays.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu import clustering as jcl  # noqa: E402
from deeplearning4j_tpu.plot import filters as jfilters  # noqa: E402
from deeplearning4j_tpu.plot import tsne as jtsne  # noqa: E402

from deeplearning4j_tpu_torch import clustering as pcl  # noqa: E402
from deeplearning4j_tpu_torch.plot import filters as pfilters  # noqa: E402
from deeplearning4j_tpu_torch.plot import tsne as ptsne  # noqa: E402

from test_torch_paragraph_vectors import F64Numpy  # noqa: E402

TOL_F64 = 1e-10


def blobs(n=60, d=5, k=3, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 4
    return centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))


class TestTrees:
    def test_kdtree(self):
        x = blobs(80, 3)
        rng = np.random.default_rng(1)
        qs = rng.standard_normal((10, 3)) * 3
        j, p = jcl.KDTree.build(x), pcl.KDTree.build(x)
        ji, pi = jcl.KDTree(3), pcl.KDTree(3)
        for i, row in enumerate(x[:30]):
            ji.insert(row, i)
            pi.insert(row)
        for q in qs:
            assert p.knn(q, 7) == j.knn(q, 7)
            assert p.nn(q) == j.nn(q)
            assert pi.knn(q, 5) == ji.knn(q, 5)
            lo, hi = q - 2, q + 2
            assert p.range(lo, hi) == j.range(lo, hi)
        assert p.size == 80 and pi.size == 30

    @pytest.mark.parametrize("distance", ["euclidean", "cosine"])
    def test_vptree(self, distance):
        x = blobs(70, 6)
        j, p = jcl.VPTree(x, distance, seed=3), pcl.VPTree(x, distance, seed=3)
        for q in x[::7]:
            assert p.knn(q, 9) == j.knn(q, 9)
            assert p.words_nearest(q, 4) == j.words_nearest(q, 4)

    def test_vptree_ties_resolve_as_in_jax(self):
        g = np.stack(np.meshgrid(np.arange(6.0), np.arange(6.0)),
                     -1).reshape(-1, 2)  # many equal distances
        j, p = jcl.VPTree(g, seed=5), pcl.VPTree(g, seed=5)
        for q in g[::5]:
            assert p.knn(q, 6) == j.knn(q, 6)

    @pytest.mark.parametrize("dim", [2, 3])
    def test_sptree_and_quadtree_forces(self, dim):
        y = blobs(50, dim, seed=4)
        y[7] = y[6]  # a duplicate point
        trees = [(jcl.SPTree.build(y), pcl.SPTree.build(y))]
        if dim == 2:
            trees.append((jcl.QuadTree.build(y), pcl.QuadTree.build(y)))
        for jt, pt in trees:
            assert pt.cum_size == jt.cum_size == 50
            for theta in (0.0, 0.5, 1.2):
                for i in range(0, 50, 4):
                    fj, fp = np.zeros(dim), np.zeros(dim)
                    qj = jt.compute_non_edge_forces(y[i], theta, fj)
                    qp = pt.compute_non_edge_forces(y[i], theta, fp)
                    assert qp == qj
                    np.testing.assert_array_equal(fp, fj)


def _p_matrix(n, seed):
    x = blobs(n, 4, seed=seed)
    return jtsne.Tsne(perplexity=8.0)._input_p(x)


class TestTsneStep:
    def test_twenty_steps_f64(self):
        n = 40
        P = _p_matrix(n, 2)
        rng = np.random.default_rng(3)
        Y = rng.normal(0, 1e-2, (n, 2))
        vel = np.zeros_like(Y)
        gains = np.ones_like(Y)
        jY, jv, jg = (jnp.asarray(a) for a in (Y, vel, gains))
        pY, pv, pg = (torch.from_numpy(a.copy()) for a in (Y, vel, gains))
        for it in range(20):
            p_use = P * (4.0 if it < 8 else 1.0)
            momentum = 0.5 if it < 12 else 0.8
            jY, jv, jg, jkl = jtsne._tsne_step(jnp.asarray(p_use), jY, jv, jg,
                                               momentum, 10.0)
            kl = ptsne.tsne_step(torch.from_numpy(p_use), pY, pv, pg,
                                 momentum, 10.0, kl=True)
            for got, want in ((pY, jY), (pv, jv), (pg, jg)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=0, atol=TOL_F64)
            assert abs(float(kl) - float(jkl)) <= TOL_F64
        assert ptsne.tsne_step(torch.from_numpy(P), pY, pv, pg, 0.8,
                               10.0) is None
        assert np.abs(pY.numpy() - Y).max() > 1e-3
        assert (pg.numpy() != 1.0).any()

    def test_input_p_equal(self):
        x = blobs(30, 4, seed=6)
        np.testing.assert_array_equal(
            ptsne.Tsne(perplexity=5.0, device="cpu")._input_p(x),
            jtsne.Tsne(perplexity=5.0)._input_p(x))
        d2 = np.abs(np.random.default_rng(1).standard_normal((12, 9)))
        np.testing.assert_array_equal(
            ptsne._binary_search_betas(d2, 3.0),
            jtsne._binary_search_betas(d2, 3.0))

    def test_exact_fit_f64(self, monkeypatch):
        """A learning rate fit for 36 points (t-SNE's 200 is tuned for
        thousands: at 36 it throws Y to |Y| ~ 100 within a few steps, where
        any two summation orders part). The 1e-10 holds to ~60 steps:
        f64 roundoff grows ~1e3 in 60 steps, ~1e6 in 120, here."""
        monkeypatch.setattr(jtsne, "np", F64Numpy())
        monkeypatch.setattr(ptsne, "np", F64Numpy())
        x = blobs(36, 5, seed=7)
        kw = dict(perplexity=6.0, max_iter=60, learning_rate=10.0,
                  exaggeration_iters=20, momentum_switch=40, seed=4)
        j = jtsne.Tsne(**kw)
        p = ptsne.Tsne(device="cpu", **kw)
        want = j.fit_transform(x)
        got = p.fit_transform(x)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=TOL_F64)
        assert len(p.kl_history) == len(j.kl_history) == 3  # 0, 50, 59
        np.testing.assert_allclose(p.kl_history, j.kl_history, rtol=0,
                                   atol=TOL_F64)
        assert np.abs(got).max() > 1.0

    def test_exact_fit_f32_separates_the_blobs(self):
        """The default f32 fit on the CPU: the KL falls and each point's
        nearest neighbour in Y lies in its own blob."""
        rng = np.random.default_rng(8)
        centers = rng.standard_normal((3, 5)) * 6
        label = rng.integers(0, 3, 45)
        x = centers[label] + rng.standard_normal((45, 5))
        p = ptsne.Tsne(perplexity=8.0, max_iter=150, learning_rate=10.0,
                       device="cpu")
        y = p.fit_transform(x)
        assert y.dtype == np.float32 and np.isfinite(y).all()
        assert p.kl_history[-1] < p.kl_history[1]
        d = ((y[:, None] - y[None]) ** 2).sum(-1)
        np.fill_diagonal(d, np.inf)
        assert (label[d.argmin(1)] == label).mean() >= 0.95


class TestBarnesHut:
    def test_thirty_iterations(self):
        x = blobs(45, 4, seed=9)
        kw = dict(perplexity=5.0, max_iter=30, exaggeration_iters=10,
                  theta=0.5, seed=1)
        j, p = jtsne.BarnesHutTsne(**kw), ptsne.BarnesHutTsne(**kw)
        ij, vj = j._sparse_input_p(x)
        ip, vp = p._sparse_input_p(x)
        np.testing.assert_array_equal(ip, ij)
        np.testing.assert_array_equal(vp, vj)
        np.testing.assert_allclose(p.fit_transform(x), j.fit_transform(x),
                                   rtol=0, atol=TOL_F64)
        np.testing.assert_allclose(p.kl_history, j.kl_history, rtol=0,
                                   atol=TOL_F64)
        assert p.device == torch.device("cpu") and p.theta == 0.5


def _ae_nets():
    """A JAX AutoEncoder + RBM network and the port network that loads its
    zip (the same weights)."""
    import os
    import tempfile

    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.utils.serialization import ModelSerializer

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (jconf.NeuralNetConfiguration.builder().seed(3).list()
            .layer(0, jconf.AutoEncoder(n_in=16, n_out=9,
                                        activation="sigmoid"))
            .layer(1, jconf.RBM(n_in=9, n_out=4))
            .layer(2, jconf.OutputLayer(n_in=4, n_out=2)).build())
    jnet = JNet(conf).init()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ae.zip")
        ModelSerializer.write_model(jnet, path)
        pnet = MultiLayerNetwork.load(path, device="cpu")
    return jnet, pnet


class TestFilters:
    def test_plot_filters(self):
        rng = np.random.default_rng(0)
        for inp, kw in ((rng.standard_normal((7, 12)),
                         dict(tile_shape=(3, 3), image_shape=(3, 4))),
                        (rng.standard_normal((5, 12)),
                         dict(tile_shape=(2, 3), image_shape=(4, 3),
                              tile_spacing=(1, 2))),
                        (rng.standard_normal((3, 4, 2, 2)),
                         dict(tile_shape=(2, 2), image_shape=(2, 2))),
                        (rng.standard_normal((1, 4, 2, 2)),
                         dict(tile_shape=(2, 2), image_shape=(2, 2)))):
            got = pfilters.PlotFilters(inp, **kw).plot()
            np.testing.assert_array_equal(
                got, jfilters.PlotFilters(inp, **kw).plot())
        with pytest.raises(ValueError):
            pfilters.PlotFilters(None).plot()

    def test_png_round_trip(self, tmp_path):
        from PIL import Image

        img = np.random.default_rng(1).random((6, 8))
        pfilters.render_image(img, str(tmp_path / "p.png"))
        jfilters.render_image(img, str(tmp_path / "j.png"))
        a = np.asarray(Image.open(tmp_path / "p.png"))
        np.testing.assert_array_equal(
            a, np.asarray(Image.open(tmp_path / "j.png")))
        np.testing.assert_array_equal(a, (img * 255).astype(np.uint8))
        assert pfilters.image_png_bytes(img) == jfilters.image_png_bytes(img)

    def test_reconstruct_and_renders(self, tmp_path):
        from deeplearning4j_tpu_torch.datasets.iterator import (
            ListDataSetIterator,
        )

        jnet, pnet = _ae_nets()
        x = np.random.default_rng(2).random((4, 16)).astype(np.float32)
        for layer in (0, 1):
            np.testing.assert_allclose(
                pfilters.reconstruct(pnet, x, layer),
                np.asarray(jfilters.reconstruct(jnet, x, layer)), rtol=0,
                atol=1e-6)
        with pytest.raises(ValueError, match="visible model"):
            pfilters.reconstruct(pnet, x, 2)
        y = np.eye(2, dtype=np.float32)[[0, 1, 0, 1]]
        rr = pfilters.ReconstructionRender(ListDataSetIterator(x, y, 4),
                                           pnet, recon_layer=0,
                                           image_shape=(4, 4))
        mosaic = rr.draw(str(tmp_path / "r.png"))
        assert mosaic.shape == (8, 16) and (tmp_path / "r.png").exists()
        with pytest.raises(StopIteration):
            rr.draw(str(tmp_path / "r2.png"))
        lst = pfilters.PlotFiltersIterationListener(
            pfilters.PlotFilters(None, tile_shape=(3, 3), image_shape=(4, 4)),
            layer=0, frequency=2, output_path=str(tmp_path / "w.png"))
        lst.iteration_done(pnet, 1, 0.0)
        assert not (tmp_path / "w.png").exists()
        lst.iteration_done(pnet, 2, 0.0)
        jplot = jfilters.PlotFilters(np.asarray(jnet.params[0]["W"]).T,
                                     tile_shape=(3, 3),
                                     image_shape=(4, 4)).plot()
        np.testing.assert_allclose(lst.filters.get_plot(), jplot, rtol=0,
                                   atol=1e-6)
