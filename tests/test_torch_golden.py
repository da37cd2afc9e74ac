"""``tests/torch_golden.json`` is current on both sides: it equals what the
JAX reference package produces today and what the port produces on the CPU.

``chip_smoke.py`` holds the port's output on a GPU against the same file,
which is how the card's results are tied to the reference's without JAX on
that machine.  Integer results and a SHA-256 of the color bytes: the bar is
equality.  Regenerate with ``tests/make_torch_golden.py``.
"""
import importlib.util
import json
import os

import pytest
import torch

from repro import api as japi
from repro.graphs.generators import paper_suite as j_paper_suite
from repro_torch import api as tapi
from repro_torch.graphs.generators import paper_suite as t_paper_suite

# one intra-op thread: the tensors here are tiny, and a pool of OpenMP
# threads per test worker only takes cores from the other workers
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden", os.path.join(HERE, "make_torch_golden.py"))
make_torch_golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_torch_golden)

with open(make_torch_golden.PATH) as _f:
    GOLDEN = json.load(_f)["results"]

J_SUITE = j_paper_suite("tiny")
T_SUITE = t_paper_suite("tiny")
KEYS = [(name, seed) for name in sorted(J_SUITE)
        for seed in make_torch_golden.SEEDS]


def test_golden_file_covers_the_suite():
    assert sorted(GOLDEN) == sorted(f"{n}/seed={s}" for n, s in KEYS)
    for entry in GOLDEN.values():
        assert sorted(entry) == sorted(make_torch_golden.FIELDS
                                       + ("colors_sha256",))
        assert len(entry["colors_sha256"]) == 64


@pytest.mark.parametrize("name,seed", KEYS)
def test_golden_equals_reference_and_port(name, seed):
    want = GOLDEN[f"{name}/seed={seed}"]
    assert make_torch_golden.entry(
        japi.color(J_SUITE[name], seed=seed)) == want, "reference package"
    assert make_torch_golden.entry(
        tapi.color(T_SUITE[name], device="cpu", seed=seed)) == want, "port"
