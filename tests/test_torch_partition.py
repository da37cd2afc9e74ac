"""The port's partition module against the reference's
(``repro_torch.core.partition`` against ``repro.core.partition``, both numpy
only): ``block_partition``, ``build_halo``, ``build_halo_mutable`` and
``partition_stats`` give arrays equal in dtype, shape and value, on a mesh,
an RMAT and a graph with isolated vertices, at 1, 2, 4 and 8 shards.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import partition as jpart
from repro.graphs import csr as jcsr
from repro.graphs import generators as jgen
from repro_torch.core import partition as tpart
from repro_torch.graphs import csr as tcsr
from repro_torch.graphs import generators as tgen

SHARDS = (1, 2, 4, 8)


def isolated(csr):
    """300 vertices: a ring over the even ones and a few chords; the odd
    ones have no edge (some shards then have no boundary at all)."""
    even = np.arange(0, 300, 2)
    e = np.stack([even, np.roll(even, -1)], 1)
    e = np.concatenate([e, [[0, 150], [2, 298], [10, 200]]])
    return csr.from_edges(300, e)


GRAPHS = {"mesh2d": lambda gen, csr: gen.mesh2d(24, 24),
          "rmat_b": lambda gen, csr: gen.rmat_b(9, 8),
          "isolated": lambda gen, csr: isolated(csr)}


def both(name):
    return GRAPHS[name](jgen, jcsr), GRAPHS[name](tgen, tcsr)


def assert_fields_equal(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, (what, f.name)
            np.testing.assert_array_equal(y, x, err_msg=f"{what}: {f.name}")
        elif dataclasses.is_dataclass(x):
            assert_fields_equal(x, y, f"{what}.{f.name}")
        else:
            assert x == y, (what, f.name)


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_block_partition_and_halo(name, D):
    jg, tg = both(name)
    jp = jpart.block_partition(jg, D, seed=5)
    tp = tpart.block_partition(tg, D, seed=5)
    assert_fields_equal(jp, tp, "partition")
    assert_fields_equal(jpart.build_halo(jp), tpart.build_halo(tp), "halo")
    W = jp.graph.max_degree + 3
    assert_fields_equal(jpart.build_halo(jp, ell_width=W),
                        tpart.build_halo(tp, ell_width=W), "halo W+3")
    assert jpart.partition_stats(jp) == tpart.partition_stats(tp)


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_halo_mutable(name, D):
    """Defaults; a taller chunk-aligned row table, a narrow ELL that spills
    to the overflow buffer, and boundary / ghost capacities forced up (the
    re-plan's arguments)."""
    jg, tg = both(name)
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    jp = jpart.block_partition(jg, D, rng=rng_j)
    tp = tpart.block_partition(tg, D, rng=rng_t)
    assert rng_j.integers(1 << 30) == rng_t.integers(1 << 30)   # one stream
    assert_fields_equal(jpart.build_halo_mutable(jp),
                        tpart.build_halo_mutable(tp), "mutable")
    kw = dict(n_loc=-(-jp.n_loc // 16) * 16 + 16, ell_cap=4, ell_slack=2,
              delta_cap=64, min_b_cap=300, min_g_cap=500)
    assert_fields_equal(jpart.build_halo_mutable(jp, **kw),
                        tpart.build_halo_mutable(tp, **kw), "mutable kw")
    kw = dict(ell_cap=6, ovf_cap=4096)
    assert_fields_equal(jpart.build_halo_mutable(jp, **kw),
                        tpart.build_halo_mutable(tp, **kw), "mutable ovf")


def test_mutable_rejects_a_short_row_table():
    tp = tpart.block_partition(tgen.mesh2d(8, 8), 4)
    with pytest.raises(ValueError, match="below partition block size"):
        tpart.build_halo_mutable(tp, n_loc=tp.n_loc - 1)
    with pytest.raises(ValueError, match="ell width >= max degree"):
        tpart.build_halo(tp, ell_width=1)


def test_relabel_is_from_edges():
    g = tgen.rmat_b(9, 8)
    perm = np.random.default_rng(1).permutation(g.n_vertices)
    want = tcsr.from_edges(g.n_vertices,
                           perm[tcsr.to_edge_list(g).astype(np.int64)],
                           symmetrize=False)
    got = tpart.relabel(g, perm)
    assert_fields_equal(want, got, "relabel")
