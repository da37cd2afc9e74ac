"""The paper's technique inside a training pipeline: color a mesh, use the
coloring as a conflict-free scatter schedule for GNN message passing, and
train a GatedGCN on the mesh — deterministic aggregation included.

    PYTHONPATH=src python -m repro_torch.examples.color_then_train_gnn [--device cpu]

On the card the coloring runs the hand-written kernels (RSOC's round 0 on
B1, its repair rounds on B2); the GNN's scatters are sorted
accumulating adds, the same bits every run.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import coloring as col
from repro_torch.core.schedule import edge_color_by_dst
from repro_torch.data.pipeline import FullGraphStream
from repro_torch.graphs import generators as gen
from repro_torch.graphs.csr import to_edge_list
from repro_torch.models import gnn as GNN
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_loop import make_train_step

CFG = GNN.GatedGCNConfig(n_layers=4, d_hidden=32, d_in=16, d_out=4)


def main(argv=None, params=None) -> dict:
    """``params``: the GatedGCN's weights (default: ``gatedgcn_init`` seed 0
    on the device).  Returns the coloring, the losses printed and the
    determinism check."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="None: the CUDA card (raises without one); cpu")
    ap.add_argument("--side", type=int, default=48)
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = api._resolve_device(args.device)

    # 1. the mesh + its coloring (dependency analysis for parallel mesh
    #    kernels)
    g = gen.mesh2d(args.side, args.side)
    res = api.color(g, algorithm="rsoc", seed=0, device=dev)
    assert col.is_proper(g, res.colors)
    print(f"mesh: {g.n_vertices} vertices; RSOC: {res.n_colors} colors in "
          f"{res.n_rounds} rounds / {res.gather_passes} passes")

    # 2. a GNN on the same mesh, trained full-batch
    cfg = CFG
    stream = FullGraphStream(g, d_feat=16, n_classes=4, pad_edges_to=1024)
    if params is None:
        params = GNN.gatedgcn_init(
            torch.Generator(device=dev).manual_seed(0), cfg, dev)
    opt = init_opt_state(params)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=args.steps)
    N = g.n_vertices + 1

    def loss_fn(p, batch):
        out = GNN.gatedgcn_apply(p, cfg, batch["feats"], batch["src"],
                                 batch["dst"], N)
        return GNN.node_classification_loss(out, batch["labels"],
                                            batch["train_mask"])

    step = make_train_step(loss_fn, ocfg)
    losses = {}
    for i in range(args.steps):
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in next(stream).items()}
        params, opt, m = step(params, opt, batch)
        if i % 10 == 0:
            losses[i] = float(m["loss"])
            print(f"step {i:3d}  loss {losses[i]:.4f}")

    # 3. deterministic aggregation via the coloring-derived edge schedule
    e = to_edge_list(g)
    src, dst = e[:, 0].astype(np.int32), e[:, 1].astype(np.int32)
    ranks, n_colors = edge_color_by_dst(src, dst, g.n_vertices)
    msg = np.random.default_rng(0).standard_normal(
        (len(src), 8)).astype(np.float32)

    def t(a):
        return torch.as_tensor(a).to(dev)

    out1 = GNN.colored_segment_sum(t(msg), t(dst).long(), g.n_vertices,
                                   t(ranks), n_colors)
    perm = np.random.default_rng(1).permutation(len(src))
    out2 = GNN.colored_segment_sum(t(msg[perm]), t(dst[perm]).long(),
                                   g.n_vertices, t(ranks[perm]), n_colors)
    same = bool(torch.equal(out1, out2))
    print("colored scatter deterministic under edge permutation:", same)
    return {"colors": res.colors, "n_colors": res.n_colors,
            "n_rounds": res.n_rounds, "gather_passes": res.gather_passes,
            "losses": losses, "deterministic": same,
            "aggregate": out1.cpu().numpy()}


if __name__ == "__main__":
    main()
