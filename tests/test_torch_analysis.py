"""Port vs reference: the roofline arithmetic (``repro_torch.launch.
analysis`` against ``repro.launch.analysis``).

Every model-FLOPs function equals the reference's exactly (the same
arithmetic on the same integers) for every ported config, full and smoke,
at every shape of ``FAMILY_SHAPES``.  ``Roofline`` has the reference's
fields and properties; its terms divide by the H100's constants
(``repro_torch.launch.mesh``) where the reference divides by a TPU v5e's.
"""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro.launch import analysis as JA
from repro.launch import mesh as JM
from repro_torch import configs as tconfigs
from repro_torch.configs.common import FAMILY_SHAPES
from repro_torch.graphs.sampler import union_caps
from repro_torch.launch import analysis as TA
from repro_torch.launch import mesh as TM


def _ported(family):
    return sorted(a for a, d in tconfigs.ARCHS.items() if d.family == family)


def _cfgs(arch, **full):
    ja, ta = jconfigs.get(arch), tconfigs.get(arch)
    return [(ja.make_smoke(), ta.make_smoke()),
            (ja.make_full(**full), ta.make_full(**full))]


@pytest.mark.parametrize("shape", sorted(FAMILY_SHAPES["lm"]))
@pytest.mark.parametrize("arch", _ported("lm"))
def test_lm_model_flops_equal_the_reference(arch, shape):
    shp = FAMILY_SHAPES["lm"][shape]
    for jc, tc in _cfgs(arch):
        assert tc.n_active_params() == jc.n_active_params()
        for kind in ("train", "prefill", "decode"):
            want = JA.lm_model_flops(jc, kind, shp["batch"], shp["seq_len"])
            assert TA.lm_model_flops(tc, kind, shp["batch"],
                                     shp["seq_len"]) == want


def _gnn_size(shp):
    """(nodes, edges) of a GNN shape as the reference's cell lays the batch
    out (``launch/cells.py::_gnn_batch_shapes``, before the edge padding): a
    sink node appended; a sampled union's caps; molecules flattened."""
    if shp["mode"] == "batched":
        return shp["batch"] * shp["n_nodes"] + 1, shp["batch"] * shp["n_edges"]
    if shp["mode"] == "sampled":
        fan = tuple(reversed(shp["fanouts"]))
        caps = union_caps(shp["batch_nodes"], fan)
        return caps[-1] + 1, sum(c * f for c, f in zip(caps[:-1], fan))
    return shp["n_nodes"] + 1, shp["n_edges"]


@pytest.mark.parametrize("shape", sorted(FAMILY_SHAPES["gnn"]))
@pytest.mark.parametrize("arch", _ported("gnn"))
def test_gnn_model_flops_equal_the_reference(arch, shape):
    shp = FAMILY_SHAPES["gnn"][shape]
    n, e = _gnn_size(shp)
    for jc, tc in _cfgs(arch, d_in=shp["d_feat"], n_classes=shp["n_classes"]):
        for train in (True, False):
            want = JA.gnn_model_flops(arch, jc, n, e, train)
            assert TA.gnn_model_flops(arch, tc, n, e, train) == want


def test_nequip_molecule_step_flops():
    """The full config on ``GNN_SHAPES["molecule"]``: 3,841 nodes with the
    sink, 8,192 edges."""
    cfg = tconfigs.get("nequip").make_full()
    assert TA.gnn_model_flops("nequip", cfg, 3841, 8192) == 5_308_968_960.0


@pytest.mark.parametrize("shape", sorted(FAMILY_SHAPES["recsys"]))
def test_recsys_model_flops_equal_the_reference(shape):
    shp = FAMILY_SHAPES["recsys"][shape]
    for jc, tc in _cfgs("dcn-v2"):
        for cfg_j, cfg_t in ((jc, tc), (dataclasses.replace(jc, cross_rank=4),
                                        dataclasses.replace(tc, cross_rank=4))):
            want = JA.recsys_model_flops(cfg_j, shp["kind"], shp["batch"],
                                         shp.get("n_candidates", 0))
            assert TA.recsys_model_flops(cfg_t, shp["kind"], shp["batch"],
                                         shp.get("n_candidates", 0)) == want
    full = tconfigs.get("dcn-v2").make_full()
    assert TA.recsys_model_flops(full, "train", 65536) == 1_008_398_893_056.0


def test_roofline_terms_use_the_h100_constants():
    assert (TM.PEAK_FLOPS_BF16, TM.HBM_BW, TM.ICI_BW) == (989e12, 3.35e12,
                                                          450e9)
    assert [f.name for f in dataclasses.fields(TA.Roofline)] == [
        f.name for f in dataclasses.fields(JA.Roofline)]
    props = [k for k, v in vars(JA.Roofline).items() if isinstance(v, property)]
    assert props == [k for k, v in vars(TA.Roofline).items()
                     if isinstance(v, property)]
    for args in ((2e15, 1e12, 5e10, 4, 1e15), (1e12, 2e12, 0.0, 1, 0.0),
                 (1e9, 1e6, 9e11, 8, 5e9)):
        t, j = TA.Roofline(*args), JA.Roofline(*args)
        assert t.t_compute == args[0] / 989e12
        assert t.t_memory == args[1] / 3.35e12
        assert t.t_collective == args[2] / 450e9
        assert t.t_compute * TM.PEAK_FLOPS_BF16 == pytest.approx(
            j.t_compute * JM.PEAK_FLOPS_BF16, rel=1e-15)
        assert t.t_bound == max(t.t_compute, t.t_memory, t.t_collective)
        ts = {"compute": t.t_compute, "memory": t.t_memory,
              "collective": t.t_collective}
        assert t.bottleneck == max(ts, key=ts.get)
        assert t.useful_ratio == j.useful_ratio
        if args[4]:
            assert t.roofline_fraction == pytest.approx(
                args[4] / (args[3] * 989e12 * t.t_bound), rel=1e-15)
        else:
            assert t.roofline_fraction is None
        d = t.as_dict()
        assert sorted(d) == sorted(j.as_dict())
        assert d["bottleneck"] == t.bottleneck
