"""Port vs reference: graph containers, generators and ``prepare``.

Everything here is integer data made on the host from a seed, so the bar is
byte-equality (tolerance zero).
"""
import numpy as np
import pytest
import torch

from repro.core import coloring as jcol
from repro.graphs import csr as jcsr
from repro.graphs import generators as jgen
from repro_torch.core import coloring as tcol
from repro_torch.graphs import csr as tcsr
from repro_torch.graphs import generators as tgen

# one intra-op thread: the tensors here are tiny, and a pool of OpenMP
# threads per test worker only takes cores from the other workers
torch.set_num_threads(1)

TINY = sorted(jgen.paper_suite("tiny"))
J_SUITE = jgen.paper_suite("tiny")
T_SUITE = tgen.paper_suite("tiny")


def _same_bytes(a, b, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("name", TINY)
def test_generators_and_ell_byte_equal(name):
    jg, tg = J_SUITE[name], T_SUITE[name]
    assert jg.n_vertices == tg.n_vertices
    _same_bytes(jg.indptr, tg.indptr, "indptr")
    _same_bytes(jg.indices, tg.indices, "indices")
    _same_bytes(jcsr.to_ell(jg), tcsr.to_ell(tg), "to_ell")
    _same_bytes(jcsr.to_ell(jg, pad_vertices_to=jg.n_vertices + 7),
                tcsr.to_ell(tg, pad_vertices_to=tg.n_vertices + 7),
                "to_ell padded")
    _same_bytes(jcsr.to_edge_list(jg), tcsr.to_edge_list(tg), "edge list")
    assert tcsr.FILL == jcsr.FILL == -1


def _assert_problem_equal(jp, tp):
    for f in ("ell", "ovf_src", "ovf_dst", "pri"):
        _same_bytes(np.asarray(getattr(jp, f)),
                    getattr(tp, f).numpy(), f)
    _same_bytes(jp.perm, tp.perm, "perm")
    assert (jp.n, jp.n_pad, jp.C) == (tp.n, tp.n_pad, tp.C)


@pytest.mark.parametrize("relabel", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", TINY)
def test_prepare_byte_equal(name, seed, relabel):
    jp = jcol.prepare(J_SUITE[name], seed=seed, relabel=relabel)
    tp = tcol.prepare(T_SUITE[name], seed=seed, relabel=relabel, device="cpu")
    _assert_problem_equal(jp, tp)
    assert tp.ovf_src.shape[0] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", TINY)
def test_prepare_overflow_coo_byte_equal(name, seed):
    """``ell_cap`` below the max degree spills hub rows into the COO side
    channel; n_chunks=7 also makes the row padding ragged."""
    kw = dict(seed=seed, n_chunks=7, ell_cap=4, C=64)
    jp = jcol.prepare(J_SUITE[name], **kw)
    tp = tcol.prepare(T_SUITE[name], device="cpu", **kw)
    _assert_problem_equal(jp, tp)
    assert tp.ovf_src.shape[0] > 0
    assert tp.ell.shape == (tp.n_pad, 4) and tp.n_pad % 7 == 0


@pytest.mark.parametrize("name", ["mesh2d", "rmat_b"])
def test_is_proper_and_greedy_agree(name):
    jg, tg = J_SUITE[name], T_SUITE[name]
    jc, tc = jcol.greedy_sequential(jg), tcol.greedy_sequential(tg)
    _same_bytes(jc, tc, "greedy colors")
    assert tcol.is_proper(tg, tc) and jcol.is_proper(jg, tc)
    bad = tc.copy()
    e = tcsr.to_edge_list(tg)[0]
    bad[e[0]] = bad[e[1]]
    assert not tcol.is_proper(tg, bad)
    assert tcol.n_colors_used(tc) == jcol.n_colors_used(jc)
