"""The dry run (``repro_torch.launch.cost`` / ``dryrun`` / ``analysis.
analyze``) against the reference's HLO walker and its ``AN.analyze``, on
the CPU.

* FLOPs: the counter's, on meta tensors, against ``repro.launch.hlo_cost.
  analyze_text`` of the reference's jitted smoke functions (one layer).  The one
  difference is attention in a prefill: on meta the port takes the card's
  route, B5, whose work is the visible (query, key) pairs, while the
  reference's jnp ``chunked_attention`` computes every (chunk x chunk)
  block, masked ones too; that part is reckoned
  (``_chunked_attention_flops``) and the rest must agree exactly
  (``FLOP_RTOL``: rounding only).
* Two full-config cells on (1, 1) and (2, 2) against the reference's
  ``AN.analyze(cell.lower(mesh).compile())`` on a JAX host mesh of 8
  devices (one subprocess): FLOPs and argument bytes a device (the
  positions' means) within ``FLOP_RTOL_CELL`` / ``ARG_RTOL``, the peak
  within ``PEAK_BAND``.
* A meta dry run against a real CPU run of the same cells: collectives,
  gathered bytes and FLOPs equal.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import mesh as tmesh
from repro_torch.kernels import cost as KC
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.launch import analysis as TAN
from repro_torch.launch import cells as TCELLS
from repro_torch.launch import dryrun as TDR
from repro_torch.launch.cost import StepCost, count_step
from repro_torch.models import layers as TL
from repro_torch.models import scatter as TSC
from repro_torch.models import transformer as TTF
from repro_torch.obs import metrics as tmetrics
from repro_torch.tree import leaves

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FLOP_RTOL = 1e-12          # the smoke functions: equal but for rounding
FLOP_RTOL_CELL = 1e-3      # a cell a device (dcn-v2 (2, 2): 1.6e-4 apart)
PEAK_BAND = (0.75, 1.33)   # port peak / reference peak
ARG_RTOL = 1e-6            # argument bytes a device (gat-cora (2, 2): 2e-7)
B, L, S = 2, 64, 128


def test_all_cells_equal_the_reference():
    from repro import configs as jconfigs
    assert tconfigs.all_cells() == jconfigs.all_cells()
    assert len(tconfigs.all_cells()) == 40


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_scanned_chain_flops(device):
    """The reference's scan-vs-unroll chain: 8 x (64, 128) @ (128, 128)."""
    x = torch.ones((64, 128), device=device)
    w = torch.ones((128, 128), device=device)

    def chain(x, w):
        for _ in range(8):
            x = torch.tanh(x @ w)
        return x

    _, c = count_step(chain, (x, w))
    assert c["flops"]["total"] == 8 * 2 * 64 * 128 * 128
    assert c["ops"] == 16


# --------------------------------------------------------------------------
# FLOPs against the reference's HLO walker, smoke configs
# --------------------------------------------------------------------------

def _chunked_attention_flops(cfg, kernels, Lq: int) -> float:
    """What the reference's ``chunked_attention`` computes where B5 counts
    its visible pairs: every (chunk_q x chunk_k) block of the padded
    square, 4 * Hq * D FLOPs a (query, key) pair."""
    b5 = kernels["flash_attention"]["flops"]
    cq, ck = min(cfg.chunk_q, Lq), min(cfg.chunk_k, Lq)
    full = (-(-Lq // cq) * cq) * (-(-Lq // ck) * ck)
    return b5 * full / KC.attention_pairs(Lq, Lq, True)


def _port_flops(arch: str, what: str):
    cfg = dataclasses.replace(tconfigs.get(arch).make_smoke(), n_layers=1)
    p = TTF.init_params(None, cfg, "meta", trainable=what == "grad")
    tok = torch.empty((B, L), dtype=torch.int32, device="meta")
    if what == "prefill":
        with torch.no_grad():
            _, c = count_step(lambda p, t: TTF.prefill(p, cfg, t), (p, tok))
        return c["flops"]["total"] - c["kernels"]["flash_attention"][
            "flops"] + _chunked_attention_flops(cfg, c["kernels"], L)
    if what == "decode":
        cache = TTF.make_empty_cache(cfg, B, S, "meta")
        one = torch.empty((B,), dtype=torch.int32, device="meta")
        with torch.no_grad():
            _, c = count_step(lambda p, t, c_, n: TTF.decode_step(
                p, cfg, t, c_, n), (p, one, cache, one))
        return c["flops"]["total"]
    batch = {"tokens": tok, "labels": tok}
    if what == "loss":
        with torch.no_grad():
            _, c = count_step(lambda p, b: TTF.train_step_loss(p, cfg, b),
                              (p, batch))
        return c["flops"]["total"]

    def loss_and_grad(p, b):
        loss = TTF.train_step_loss(p, cfg, b)
        return torch.autograd.grad(loss, leaves(p), allow_unused=True,
                                   materialize_grads=True)

    _, c = count_step(loss_and_grad, (p, batch))
    return c["flops"]["total"]


def _ref_flops(arch: str, what: str):
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch.hlo_cost import analyze_text
    from repro.models import transformer as JTF
    cfg = dataclasses.replace(jconfigs.get(arch).make_smoke(), n_layers=1)
    p = JTF.init_params(jax.random.PRNGKey(0), cfg)
    tok = jnp.ones((B, L), jnp.int32)
    if what == "prefill":
        f, args = (lambda p, t: JTF.prefill(p, cfg, t)), (p, tok)
    elif what == "decode":
        one = jnp.ones((B,), jnp.int32)
        f = lambda p, t, c, n: JTF.decode_step(p, cfg, t, c, n)  # noqa
        args = (p, one, JTF.make_empty_cache(cfg, B, S), one)
    else:
        batch = {"tokens": tok, "labels": tok}
        f = lambda p, b: JTF.train_step_loss(p, cfg, b)          # noqa
        if what == "grad":
            f = jax.value_and_grad(f)
        args = (p, batch)
    return analyze_text(jax.jit(f).lower(*args).compile().as_text())["flops"]


@pytest.mark.parametrize("arch,what", [
    ("qwen3-1.7b", "prefill"), ("qwen3-1.7b", "decode"),
    ("qwen3-1.7b", "grad"), ("minicpm3-4b", "prefill"),
    ("qwen2-moe-a2.7b", "prefill")])
def test_flops_equal_the_reference_hlo_walker(arch, what):
    got, want = _port_flops(arch, what), _ref_flops(arch, what)
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=FLOP_RTOL)


# --------------------------------------------------------------------------
# two full-config cells against the reference's analyze
# --------------------------------------------------------------------------

CELLS = [("gat-cora", "full_graph_sm"), ("dcn-v2", "serve_p99")]
MESHES = [(1, 1), (2, 2)]

SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
from repro.launch import analysis as AN, cells as CELLS, dryrun as DR
out = {}
for arch, shape in json.loads(sys.argv[1]):
    for d, m in json.loads(sys.argv[2]):
        mesh = jax.make_mesh((d, m), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        cell = CELLS.build_cell(arch, shape, mesh)
        r = AN.analyze(cell.lower(mesh).compile(), d * m,
                       model_flops=DR.model_flops_for(arch, shape))
        out[f"{arch}|{shape}|{d}x{m}"] = r
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def ref_proc():
    """The reference's side of the cells, started with the module's first
    test so that it runs beside the others."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    env.pop("XLA_FLAGS", None)
    p = subprocess.Popen([sys.executable, "-c", SCRIPT, json.dumps(CELLS),
                          json.dumps(MESHES)], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=env)
    try:
        yield p
    finally:
        if p.poll() is None:
            p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def ref_cells(ref_proc):
    out, err = ref_proc.communicate(timeout=600)
    assert ref_proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("dm", MESHES, ids=lambda dm: f"{dm[0]}x{dm[1]}")
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_equals_the_reference_analyze(ref_cells, arch, shape, dm):
    want = ref_cells[f"{arch}|{shape}|{dm[0]}x{dm[1]}"]
    mesh = tmesh.make_mesh(dm, ("data", "model"), device="meta")
    got = TDR.run_cell(arch, shape, False, verbose=False, mesh=mesh)
    np.testing.assert_allclose(got["roofline"]["flops_per_device"],
                               want["roofline"]["flops_per_device"],
                               rtol=FLOP_RTOL_CELL)
    assert got["roofline"]["model_flops"] == want["roofline"]["model_flops"]
    # the positions' mean; an uneven split's blocks differ by a few bytes
    np.testing.assert_allclose(got["memory"]["argument_size_in_bytes"],
                               want["memory"]["argument_size_in_bytes"],
                               rtol=ARG_RTOL)
    ratio = (got["memory"]["peak_bytes_per_device"]
             / want["memory"]["peak_bytes_per_device"])
    assert PEAK_BAND[0] <= ratio <= PEAK_BAND[1], ratio
    assert set(got["collectives"]) == set(want["collectives"])
    assert set(got["roofline"]) == set(want["roofline"])


@pytest.mark.parametrize("arch,shape", [("gat-cora", "full_graph_sm"),
                                        ("gatedgcn", "molecule"),
                                        ("dcn-v2", "serve_p99"),
                                        ("dcn-v2", "train_batch")])
def test_meta_run_records_what_a_cpu_run_records(arch, shape):
    """The same smoke cell on (2, 2), on meta and on the CPU: the counter's
    collectives and FLOPs (the total: which position a backward op is
    billed to follows the storages, see ``launch/cost.py``), and
    ``core.mesh``'s own counters, equal."""
    sizes = {"batch": 64} if arch == "dcn-v2" else {}
    got = {}
    for dev in ("meta", "cpu"):
        mesh = tmesh.make_mesh((2, 2), ("data", "model"), device=dev)
        cell = TCELLS.build_cell(arch, shape, mesh, smoke=True, sizes=sizes)
        tmetrics.reset()
        _, c = count_step(lambda *_: cell.run(), cell.args, mesh)
        got[dev] = (c["collectives"], c["collectives_position_0"],
                    c["flops"]["total"], tmesh.collectives(),
                    tmesh.gathered_bytes())
    assert got["meta"] == got["cpu"]
    assert got["meta"][3] > 0


# --------------------------------------------------------------------------
# the production mesh: one cell of each kind
# --------------------------------------------------------------------------

REF_KEYS = {"roofline", "collectives", "memory", "xla_cost_crosscheck",
            "arch", "shape", "kind", "mesh", "t_lower_s", "t_compile_s",
            "overrides", "ok"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "peak_bytes_per_device"}


@pytest.mark.parametrize("arch,shape,kind", [
    ("qwen3-1.7b", "prefill_32k", "prefill"),
    ("qwen3-1.7b", "long_500k", "decode"),
    ("gat-cora", "full_graph_sm", "train"),
    ("dcn-v2", "serve_p99", "serve"),
    ("dcn-v2", "retrieval_cand", "retrieval")])
def test_one_cell_of_each_kind_on_the_production_mesh(arch, shape, kind):
    over = {"n_layers": 1} if tconfigs.get(arch).family == "lm" else None
    r = TDR.run_cell(arch, shape, False, verbose=False, overrides=over)
    assert r["ok"] and r["kind"] == kind and r["mesh"] == "16x16"
    assert REF_KEYS - {"xla_cost_crosscheck", "t_lower_s",
                       "t_compile_s"} <= set(r)
    assert {"t_build_s", "t_count_s"} <= set(r)
    assert MEMORY_KEYS <= set(r["memory"])
    assert set(r["collectives"]) == set(TAN.parse_collectives([]))
    assert r["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert r["flops"]["outside"] == 0.0
    if kind == "prefill":      # B5 a layer a position, never chunked
        assert r["kernels"]["flash_attention"]["calls"] == 256
    else:
        assert "flash_attention" not in r["kernels"]


def test_train_cell_depth_probe_is_exact():
    """An LM train cell is counted at 2 and 3 layers and extrapolated: the
    extrapolation equals a count at 5 layers in FLOPs, ops, collectives
    and kernel calls."""
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device="meta")
    cut = dict(smoke=True, batch=4, seq_len=32)
    got = {k: TDR._count("qwen3-1.7b", "train_4k", mesh, {"n_layers": k},
                         cut)[1] for k in (*TDR.PROBE_DEPTHS, 5)}
    e = TDR.extrapolate(got[2], got[3], 5)
    assert e["flops"]["total"] == got[5]["flops"]["total"]
    assert e["ops"] == got[5]["ops"]
    assert e["collectives"] == got[5]["collectives"]
    assert e["kernels"] == got[5]["kernels"] == {}
    assert e["memory"]["argument_size_in_bytes"] == \
        got[5]["memory"]["argument_size_in_bytes"]


def test_cli_records_a_failure_and_skips_done_cells(tmp_path):
    out = tmp_path / "dry.jsonl"
    rc = TDR.main(["--arch", "gat-cora", "--shape", "full_graph_sm",
                   "--set", "halo=true", "--out", str(out)])
    rec = [json.loads(x) for x in out.read_text().splitlines()]
    assert rc == 1 and len(rec) == 1 and rec[0]["ok"] is False
    assert "halo" in rec[0]["error"] and rec[0]["mesh"] == "16x16"
    out.write_text(json.dumps({"arch": "gat-cora", "shape": "full_graph_sm",
                               "mesh": "16x16", "ok": True}) + "\n")
    assert TDR.main(["--arch", "gat-cora", "--shape", "full_graph_sm",
                     "--out", str(out), "--skip-done"]) == 0
    assert len(out.read_text().splitlines()) == 1


# --------------------------------------------------------------------------
# meta takes the card's routes; the CPU's are unchanged
# --------------------------------------------------------------------------

def test_meta_attention_records_b5_and_never_runs_the_plain_version(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on meta")

    monkeypatch.setattr(ref, "flash_attention_ref", refuse)
    monkeypatch.setattr(TL, "chunked_attention", refuse)
    q = torch.empty((2, 8, 96, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 2, 96, 64), dtype=torch.bfloat16, device="meta")
    counter = StepCost()
    with KC.listen(counter), counter:
        out = TL.prefill_attention(q, k, k, causal=True, chunk_q=32,
                                   chunk_k=32)
    assert out.shape == q.shape and out.device.type == "meta"
    flops, nbytes = KC.attention_work(2, 8, 2, 96, 96, 64, True, 2)
    assert counter.kernels == {"flash_attention": {
        "calls": 1, "flops": float(flops), "bytes": float(nbytes)}}
    assert flops == 4 * 2 * 8 * 64 * (96 * 97 // 2)


def test_cpu_routes_are_unchanged():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 4, 40, 16), generator=g) for _ in range(3))
    got = TL.prefill_attention(q, k[:, :2], v[:, :2], causal=True,
                               chunk_q=16, chunk_k=16)
    want = TL.chunked_attention(q, k[:, :2], v[:, :2], causal=True,
                                q_offset=0, chunk_q=16, chunk_k=16)
    assert torch.equal(got, want)
    assert torch.equal(ops.attention(q, k, v), ref.flash_attention_ref(
        q, k, v, causal=True))
    assert KC.on_card(torch.empty(1, device="meta"))
    assert not KC.on_card(torch.empty(1))


def test_meta_scatter_takes_the_cards_sorted_adds():
    names = {}

    class Ops(StepCost):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            names.setdefault(self._dev, set()).add(func._overloadpacket
                                                   .__name__)
            return super().__torch_dispatch__(func, types, args, kwargs)

    for dev in ("cpu", "meta"):
        c = Ops()
        c._dev = dev
        src = torch.ones((6, 3), device=dev)
        idx = torch.tensor([0, 2, 2, 1, 0, 2]).to(dev)
        with c:
            TSC.segment_sum(src, idx, 3)
    assert "index_add_" in names["cpu"] and "index_put_" not in names["cpu"]
    assert "index_put_" in names["meta"] and "index_add_" not in names["meta"]


@pytest.mark.cuda
def test_card_attention_records_the_meta_work_and_launches(cuda_device):
    q = torch.randn((1, 4, 128, 64), device=cuda_device,
                    dtype=torch.bfloat16)
    k = torch.randn((1, 2, 128, 64), device=cuda_device,
                    dtype=torch.bfloat16)
    records = {}
    for dev in ("meta", cuda_device):
        counter = StepCost()
        before = FA.flash_attention.launches
        with KC.listen(counter), counter, torch.no_grad():
            ops.attention(q.to(dev), k.to(dev), k.to(dev))
        records[str(dev)] = (counter.kernels,
                             FA.flash_attention.launches - before)
    assert records["meta"][0] == records[str(cuda_device)][0]
    assert records["meta"][1] == 0 and records[str(cuda_device)][1] == 1
