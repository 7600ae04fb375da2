"""The port's graph package and DeepWalk against the JAX package's, on
the CPU.

  * ``Graph``: adjacency, degrees, directed edges, self loops, neighbour
    draws from the same generator; the edge-list loaders on one file.
  * The walks (uniform, weighted, self-loop and exception handling) equal
    to JAX's on the same seed, vertex for vertex.
  * ``build_graph_huffman``'s tensors equal; the window pairs in the JAX
    loop's order.
  * ``fit`` in f64 (the tables lifted after ``initialize``; JAX's HS step
    run uncompiled, see ``test_torch_paragraph_vectors.uncompiled_jax``):
    both tables at 1e-10 over several epochs and a batch size that leaves
    a padded last batch; the default f32 fit against JAX's compiled step
    at 1e-5.
  * The ``.npz`` file both ways: the port reads JAX's and JAX reads the
    port's, bit-equal.
  * JAX's community tests (``tests/test_graph_embeddings.py``) on the port.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX reference side

from deeplearning4j_tpu import graph as jgraph  # noqa: E402
from deeplearning4j_tpu.graph import deepwalk as jdw  # noqa: E402

from deeplearning4j_tpu_torch import graph as pgraph  # noqa: E402
from deeplearning4j_tpu_torch.graph import deepwalk as pdw  # noqa: E402

from test_torch_paragraph_vectors import uncompiled_jax  # noqa: E402

TOL_F64 = 1e-10
TOL_F32 = 1e-5


def sbm(pkg, n_comm=3, n_per=8, p_in=0.7, p_out=0.08, seed=0, **kw):
    """A seeded stochastic block model in ``pkg``'s Graph, plus a vertex
    with no edge (for the self-loop walks)."""
    rng = np.random.default_rng(seed)
    n = n_comm * n_per
    g = pkg.Graph(n + 1, **kw)
    for a in range(n):
        for b in range(a + 1, n):
            p = p_in if a // n_per == b // n_per else p_out
            if rng.random() < p:
                g.add_edge(a, b, weight=float(rng.integers(1, 4)))
    return g


class TestGraphAndLoaders:
    @pytest.mark.parametrize("directed", [False, True])
    def test_graph_matches_jax(self, directed):
        gj, gp = sbm(jgraph, directed=directed), sbm(pgraph,
                                                     directed=directed)
        gj.add_edge(2, 2)
        gp.add_edge(2, 2)
        np.testing.assert_array_equal(gp.degrees(), gj.degrees())
        for v in range(gj.num_vertices()):
            assert gp.get_connected_vertex_indices(v) == \
                gj.get_connected_vertex_indices(v)
            assert [(e.src, e.dst, e.weight, e.directed)
                    for e in gp.get_edges_out(v)] == \
                [(e.src, e.dst, e.weight, e.directed)
                 for e in gj.get_edges_out(v)]
        rj, rp = np.random.default_rng(3), np.random.default_rng(3)
        assert [gp.get_random_connected_vertex(1, rp) for _ in range(20)] \
            == [gj.get_random_connected_vertex(1, rj) for _ in range(20)]
        with pytest.raises(pgraph.api.NoEdgesException):
            gp.get_random_connected_vertex(gp.num_vertices() - 1, rp)
        assert gp.get_vertex(3).idx == 3

    def test_loaders(self, tmp_path):
        path = tmp_path / "edges.txt"
        path.write_text("// a comment\n0,1\n1,2,2.5\n\n3,0,0.5\n")
        for name in ("load_delimited_edges", "load_weighted_edges"):
            for directed in (False, True):
                gj = getattr(jgraph, name)(str(path), 4, directed=directed)
                gp = getattr(pgraph, name)(str(path), 4, directed=directed)
                for v in range(4):
                    assert [(e.dst, e.weight) for e in gp.get_edges_out(v)] \
                        == [(e.dst, e.weight) for e in gj.get_edges_out(v)]


class TestWalks:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_walks_equal_jax(self, weighted):
        gj, gp = sbm(jgraph), sbm(pgraph)
        cls = "WeightedRandomWalkIterator" if weighted else \
            "RandomWalkIterator"
        wj = list(getattr(jgraph, cls)(gj, 12, seed=4))
        wp = list(getattr(pgraph, cls)(gp, 12, seed=4))
        assert len(wp) == gp.num_vertices()
        for a, b in zip(wp, wj):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert (wp[-1] == gp.num_vertices() - 1).all()  # the self loop

    def test_exception_on_disconnected(self):
        gp = sbm(pgraph)
        it = pgraph.RandomWalkIterator(
            gp, 5, no_edge_handling=pgraph.NoEdgeHandling
            .EXCEPTION_ON_DISCONNECTED, first_vertex=gp.num_vertices() - 1)
        with pytest.raises(pgraph.api.NoEdgesException):
            list(it)


class TestDeepWalkAgainstJax:
    def test_huffman_tensors_and_pairs(self):
        deg = sbm(jgraph).degrees()
        for a, b in zip(pdw.build_graph_huffman(deg),
                        jdw.build_graph_huffman(deg)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        walks = [np.array([3, 1, 4, 1, 5, 9, 2], np.int32),
                 np.array([6], np.int32), np.array([5, 3], np.int32)]
        cen, ctx = pdw.walk_pairs(walks, 2)
        want = [(int(w[i]), int(w[c])) for w in walks
                for i in range(len(w))
                for c in range(max(0, i - 2), min(len(w), i + 3)) if c != i]
        assert list(zip(cen.tolist(), ctx.tolist())) == want

    @pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
    def test_fit_matches(self, f64, monkeypatch):
        kw = dict(vector_size=12, window_size=3, learning_rate=0.05, seed=2,
                  batch_size=96)
        gj, gp = sbm(jgraph), sbm(pgraph)
        j = jdw.DeepWalk(**kw).initialize(gj)
        p = pdw.DeepWalk(device="cpu", **kw).initialize(gp)
        if f64:
            uncompiled_jax(monkeypatch)
            monkeypatch.setattr(jdw, "_skipgram_hs_step",
                                jdw._skipgram_hs_step.__wrapped__)
            for m in (j, p):
                m.vertex_vectors = m.vertex_vectors.astype(np.float64)
                m._syn1 = m._syn1.astype(np.float64)
        j.fit(gj, walk_length=10, epochs=3)
        p.fit(gp, walk_length=10, epochs=3)
        assert p.fit_stats["pairs"] % kw["batch_size"] != 0
        tol = TOL_F64 if f64 else TOL_F32
        for got, want in ((p.vertex_vectors, j.vertex_vectors),
                          (p._syn1, j._syn1)):
            want = np.asarray(want)
            assert got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        assert np.abs(p._syn1).max() > 1e-3
        assert p.vertices_nearest(0, 5) == j.vertices_nearest(0, 5)
        assert p.similarity(0, 1) == pytest.approx(j.similarity(0, 1),
                                                   abs=1e-5)

    def test_npz_both_ways(self, tmp_path):
        g = sbm(jgraph)
        j = jdw.DeepWalk(vector_size=8, window_size=2, seed=3).fit(
            g, walk_length=8)
        j.save(str(tmp_path / "jax"))
        p = pdw.DeepWalk.load(str(tmp_path / "jax.npz"), device="cpu")
        p.fit(sbm(pgraph), walk_length=8)  # a loaded model trains on
        p.save(str(tmp_path / "port.npz"))
        back = jdw.DeepWalk.load(str(tmp_path / "port.npz"))
        for a, b in ((back.vertex_vectors, p.vertex_vectors),
                     (back._syn1, p._syn1)):
            np.testing.assert_array_equal(np.asarray(a), b)
        for a, b in zip(back._huffman, p._huffman):
            np.testing.assert_array_equal(a, b)
        assert (back.vector_size, back.window_size, back.num_vertices,
                back.learning_rate) == (p.vector_size, p.window_size,
                                        p.num_vertices, p.learning_rate)

    def test_fit_walks_needs_initialize(self):
        with pytest.raises(RuntimeError, match="initialize"):
            pdw.DeepWalk(device="cpu").fit_walks([np.arange(3)])


def two_communities(n_per=8):
    """JAX's tests/test_graph_embeddings.py fixture in the port's Graph:
    two cliques joined by one bridge."""
    g = pgraph.Graph(2 * n_per)
    for base in (0, n_per):
        for i in range(n_per):
            for j in range(i + 1, n_per):
                g.add_edge(base + i, base + j)
    g.add_edge(0, n_per)  # bridge
    return g


class TestDeepWalkEndToEnd:
    def test_communities_cluster(self):
        g = two_communities(n_per=8)
        dw = pdw.DeepWalk(vector_size=16, window_size=4, learning_rate=0.05,
                          seed=1, device="cpu")
        dw.fit(g, walk_length=20, epochs=8)
        in_sims, out_sims = [], []
        for i in range(1, 8):
            in_sims.append(dw.similarity(1, i + 0) if i != 1 else 1.0)
            out_sims.append(dw.similarity(1, 8 + i))
        assert np.mean(in_sims) > np.mean(out_sims)

    def test_nearest_within_community(self):
        g = two_communities(n_per=8)
        dw = pdw.DeepWalk(vector_size=16, window_size=4, learning_rate=0.05,
                          seed=2, device="cpu")
        dw.fit(g, walk_length=20, epochs=8)
        near = dw.vertices_nearest(3, top_n=5)
        assert sum(1 for v in near if v < 8) >= 3
