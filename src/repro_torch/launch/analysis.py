"""Roofline bookkeeping: the three roofline terms and the useful-FLOPs
(MODEL_FLOPS) estimates of every cell (the port of the reference's
``launch/analysis.py``, against the H100 constants of ``launch/mesh.py``).

The reference's ``parse_collectives`` and ``analyze`` read XLA's HLO text
and have no counterpart: the port is eager PyTorch and compiles no HLO.
``Roofline`` takes its FLOPs, bytes and collective bytes from the caller.
The model-FLOPs functions are the reference's arithmetic, unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    coll_bytes_per_device: float
    n_chips: int
    model_flops: float = 0.0         # 6*N*D style useful-FLOPs estimate

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / ICI_BW

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> Optional[float]:
        total = self.flops_per_device * self.n_chips
        return (self.model_flops / total) if (self.model_flops and total) \
            else None

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Fraction of the compute roofline achievable at the bound:
        useful model FLOPs / (chips * peak * bound-time)."""
        if not self.model_flops or self.t_bound <= 0:
            return None
        return self.model_flops / (self.n_chips * PEAK_FLOPS_BF16
                                   * self.t_bound)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


# --------------------------------------------------------------------------
# useful-FLOPs (MODEL_FLOPS) estimates per cell
# --------------------------------------------------------------------------

def lm_model_flops(cfg, kind: str, batch: int, seq_len: int) -> float:
    """Useful FLOPs: 6*N*D (train) / 2*N*D (inference) linear term plus the
    ideal causal attention term (2*B*L^2*H*Dh per layer fwd, x3 train)."""
    n_active = cfg.n_active_params()
    h_dh = cfg.n_heads * cfg.head_dim
    if kind == "train":
        attn = 6.0 * cfg.n_layers * batch * seq_len ** 2 * h_dh * 0.5
        return 6.0 * n_active * batch * seq_len + attn
    if kind == "prefill":
        attn = 2.0 * cfg.n_layers * batch * seq_len ** 2 * h_dh * 0.5
        return 2.0 * n_active * batch * seq_len + attn
    # decode: one token per request against a seq_len cache
    attn = 4.0 * cfg.n_layers * batch * seq_len * h_dh
    return 2.0 * n_active * batch + attn


def gnn_model_flops(arch: str, cfg, n_nodes: int, n_edges: int,
                    train: bool = True) -> float:
    if arch == "gat-cora":
        per_l = 2 * n_nodes * cfg.d_in * cfg.n_heads * cfg.d_hidden \
            + 4 * n_edges * cfg.n_heads * cfg.d_hidden
        f = cfg.n_layers * per_l
    elif arch == "meshgraphnet":
        d = cfg.d_hidden
        per_l = 2 * n_edges * (3 * d) * d + 2 * n_edges * d * d \
            + 2 * n_nodes * (2 * d) * d + 2 * n_nodes * d * d
        f = cfg.n_layers * per_l
    elif arch == "gatedgcn":
        d = cfg.d_hidden
        f = cfg.n_layers * (2 * 3 * n_nodes * d * d + 2 * 2 * n_edges * d * d)
    else:                                     # nequip
        C = cfg.channels
        n_paths = len(cfg.paths)
        # per edge per path: C * (2l1+1)(2l2+1)(2l3+1) MACs ~ C*27 at l_max=2
        f = cfg.n_layers * n_edges * n_paths * C * 27 * 2 \
            + cfg.n_layers * 2 * n_nodes * 2 * C * C * 9
    return (3.0 if train else 1.0) * f


def recsys_model_flops(cfg, kind: str, batch: int,
                       n_candidates: int = 0) -> float:
    d = cfg.d_x0
    cross = cfg.n_cross_layers * 2 * d * d
    mlp, d_in = 0, d
    for h in cfg.mlp_dims:
        mlp += 2 * d_in * h
        d_in = h
    per_ex = cross + mlp + cfg.n_sparse * cfg.embed_dim  # + bag gather adds
    if kind == "retrieval":
        return per_ex + 2.0 * n_candidates * cfg.mlp_dims[-1]
    return (3.0 if kind == "train" else 1.0) * batch * per_ex
