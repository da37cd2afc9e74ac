"""Config substrate: architecture definitions + per-family shape tables.

The port's own copy of ``src/repro/configs/common.py`` (the port imports
nothing of the reference package).  Every ported architecture is a module
defining ``ARCH = ArchDef(...)``; the registry (``configs/__init__.py``)
maps ``--arch <id>`` to it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str                     # lm | gnn | recsys
    make_full: Callable[[], Any]    # full published config
    make_smoke: Callable[[], Any]   # reduced same-family config
    notes: str = ""
    # family-specific extras (gnn: feature dims per shape; lm: none)
    extras: dict = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------------
# input-shape sets (as the reference's)
# --------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k":    {"kind": "train",   "seq_len": 4096,    "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768,   "batch": 32},
    "decode_32k":  {"kind": "decode",  "seq_len": 32768,   "batch": 128},
    "long_500k":   {"kind": "decode",  "seq_len": 524288,  "batch": 1},
}

GNN_SHAPES = {
    "full_graph_sm": {"kind": "train", "mode": "full", "n_nodes": 2_708,
                      "n_edges": 10_556, "d_feat": 1_433, "n_classes": 7},
    "minibatch_lg":  {"kind": "train", "mode": "sampled", "n_nodes": 232_965,
                      "n_edges": 114_615_892, "batch_nodes": 1_024,
                      "fanouts": (15, 10), "d_feat": 602, "n_classes": 41},
    "ogb_products":  {"kind": "train", "mode": "full", "n_nodes": 2_449_029,
                      "n_edges": 61_859_140, "d_feat": 100, "n_classes": 47},
    "molecule":      {"kind": "train", "mode": "batched", "n_nodes": 30,
                      "n_edges": 64, "batch": 128, "d_feat": 16,
                      "n_classes": 8},
}

RECSYS_SHAPES = {
    "train_batch":    {"kind": "train",     "batch": 65_536},
    "serve_p99":      {"kind": "serve",     "batch": 512},
    "serve_bulk":     {"kind": "serve",     "batch": 262_144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}

FAMILY_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}


def shapes_for(family: str) -> dict:
    return FAMILY_SHAPES[family]
