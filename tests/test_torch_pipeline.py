"""Port vs reference: the data streams (``repro_torch.data.pipeline``) and
the fanout sampler (``repro_torch.graphs.sampler``) against ``repro.data.
pipeline`` and ``repro.graphs.sampler``.

The streams and the host sampler are numpy in both packages: their batches
must be equal bit for bit at the same seed and step, and a stream restored
from its state continues the same sequence (all but the sampled one, in
both packages).  The device sampler
(``sample_fanout_torch``) draws from a ``torch.Generator``, so it is held
to the reference's invariants, not to its numbers.
"""
import numpy as np
import pytest
import torch

from repro.data import pipeline as JDP
from repro.graphs import generators as jgen
from repro.graphs import sampler as JS
from repro_torch.data import pipeline as TDP
from repro_torch.graphs import csr as tcsr
from repro_torch.graphs import generators as tgen
from repro_torch.graphs import sampler as TS

torch.set_num_threads(1)


def _streams(dp, gen):
    g = gen.erdos_renyi(300, 6.0, seed=1)
    return {
        "token": lambda: dp.TokenStream(batch=3, seq_len=16, vocab=100,
                                        seed=5),
        "recsys": lambda: dp.RecsysStream(batch=4, n_dense=5, n_sparse=3,
                                          vocabs=[7, 11, 13], seed=2),
        "recsys_bags": lambda: dp.RecsysStream(batch=4, n_dense=5,
                                               n_sparse=3,
                                               vocabs=[7, 11, 13],
                                               max_hots=3, seed=2),
        "full_graph": lambda: dp.FullGraphStream(g, d_feat=6, n_classes=4,
                                                 seed=3, pad_edges_to=256),
        "sampled_graph": lambda: dp.SampledGraphStream(
            g, d_feat=6, n_classes=4, batch_nodes=32, fanouts=(4, 3),
            seed=4),
        "molecule": lambda: dp.MoleculeStream(n_nodes=10, n_edges=24,
                                              batch=3, seed=6),
    }


KINDS = sorted(_streams(JDP, jgen))


def _equal(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("kind", KINDS)
def test_stream_equals_the_reference_and_restores(kind):
    """Steps 0-2 bit-equal; both packages' streams restored from the state
    after step 1 give the same batch, and it is step 2 again — but for
    ``SampledGraphStream``, whose ``restore`` starts its sampler's RNG
    afresh from the seed (the reference's behaviour: the sampler's draws
    are not counter-based), so a restored sampled stream takes other
    neighbours than the uninterrupted one."""
    js = _streams(JDP, jgen)[kind]()
    ts = _streams(TDP, tgen)[kind]()
    for step in range(2):
        _equal(next(ts), next(js), f"{kind} step {step}")
    state = ts.state()
    assert state == js.state()
    b2 = next(ts)
    _equal(b2, next(js), f"{kind} step 2")
    restored = []
    for dp, gen in ((TDP, tgen), (JDP, jgen)):
        again = _streams(dp, gen)[kind]()
        again.restore(state)
        restored.append(next(again))
    _equal(restored[0], restored[1], f"{kind} restored")
    if kind != "sampled_graph":
        _equal(restored[0], b2, f"{kind} restored")


def test_sampler_equals_the_reference():
    """``NeighborSampler`` blocks, ``pad_batch`` and ``union_pad`` equal
    the reference's at the same seed."""
    jg = jgen.erdos_renyi(500, 6.0, seed=1)
    tg = tgen.erdos_renyi(500, 6.0, seed=1)
    fanouts = (5, 3)
    seeds = np.random.default_rng(0).choice(500, 64, replace=False)
    jb = JS.NeighborSampler(jg, fanouts, seed=0).sample(seeds)
    tb = TS.NeighborSampler(tg, fanouts, seed=0).sample(seeds)
    for jblk, tblk in zip(jb.blocks, tb.blocks, strict=True):
        for f in ("dst_nodes", "src_nodes", "nbr_local"):
            np.testing.assert_array_equal(getattr(tblk, f),
                                          getattr(jblk, f), err_msg=f)
    np.testing.assert_array_equal(tb.node_ids, jb.node_ids)
    sizes = TS.NeighborSampler(tg, fanouts).padded_sizes(64)
    assert sizes == JS.NeighborSampler(jg, fanouts).padded_sizes(64)
    _equal(TS.pad_batch(tb, sizes, fanouts), JS.pad_batch(jb, sizes, fanouts),
           "pad_batch")
    _equal(TS.union_pad(tb, 64, fanouts, pad_edges_to=1024),
           JS.union_pad(jb, 64, fanouts, pad_edges_to=1024), "union_pad")


def test_sampler_union_invariants():
    """The reference's test (``tests/test_system.py``) on the port:
    dst-prefix invariant and sink isolation of the minibatch substrate."""
    g = tgen.erdos_renyi(500, 6.0, seed=1)
    fanouts = (5, 3)
    s = TS.NeighborSampler(g, fanouts, seed=0)
    seeds = np.random.default_rng(0).choice(500, 64, replace=False)
    batch = s.sample(seeds)
    np.testing.assert_array_equal(batch.blocks[-1].dst_nodes, seeds)
    for k in range(len(batch.blocks) - 1):
        outer, inner = batch.blocks[k], batch.blocks[k + 1]
        np.testing.assert_array_equal(
            outer.src_nodes[:len(inner.src_nodes)], inner.src_nodes)
    out = TS.union_pad(batch, 64, fanouts, pad_edges_to=1024)
    caps = TS.union_caps(64, fanouts)
    sink = caps[-1]
    assert out["nodes"].shape == (caps[-1] + 1,)
    assert out["src"].shape == out["dst"].shape
    assert out["src"].shape[0] % 1024 == 0
    pad_mask = out["src"] == sink
    np.testing.assert_array_equal(out["dst"][pad_mask], sink)
    assert (out["dst"][~pad_mask] < caps[-2]).all()
    assert (out["src"] <= sink).all() and (out["src"] >= 0).all()


def test_device_sampler_invariants():
    """Every sampled id is a neighbour of its seed (FILL for an isolated
    seed), the shape is (b, fanout), and one generator seed repeats its
    draws."""
    edges = np.random.default_rng(2).integers(0, 200, (600, 2))
    g = tcsr.from_edges(201, edges)          # vertex 200 is isolated
    ell = torch.from_numpy(tcsr.to_ell(g))
    deg = torch.from_numpy(g.degrees)
    seeds = torch.tensor(list(range(0, 200, 3)) + [200], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    out = TS.sample_fanout_torch(gen, ell, deg, seeds, 7)
    assert out.shape == (len(seeds), 7) and out.dtype == ell.dtype
    for row, s in zip(out.tolist(), seeds.tolist()):
        if g.degrees[s] == 0:
            assert row == [int(tcsr.FILL)] * 7
        else:
            assert set(row) <= set(g.neighbors(s).tolist()), s
    again = TS.sample_fanout_torch(torch.Generator().manual_seed(0), ell, deg,
                                   seeds, 7)
    assert torch.equal(out, again)
    # uniform over the neighbours: a degree-d seed's draws cover them
    big = TS.sample_fanout_torch(gen, ell, deg, seeds[:1], 2000)
    assert set(big[0].tolist()) == set(g.neighbors(0).tolist())
