"""NequIP (arXiv:2101.03164): E(3)-equivariant interatomic potential (the
port of the reference's ``models/equivariant.py``).

Irrep features are dicts ``{l: (N, C, 2l+1)}`` (uniform multiplicity C per
order l, l <= l_max).  The interaction block follows the paper:

  message_ij = sum over CG paths (l1, l2 -> l3):
               R_path(|r_ij|) * CG[(l1 m1)(l2 m2)(l3 m3)] *
               h_j^{l1 c m1} * Y^{l2 m2}(r_ij / |r_ij|)
  h_i^{l3}  <- self_linear(h_i) + dst-aggregated messages   (segment_sum)
  gate      : l=0 channels -> silu; l>0 channels scaled by sigmoid(scalar gate)

Real spherical harmonics and real Clebsch-Gordan coupling coefficients are
built numerically on the host (numpy, cached; the port's own copy of the
reference's code): complex CG via the Racah formula, rotated into the real
basis with the standard unitary U^l.

Indexing follows the reference's.  A row gather wraps a negative id (-1 is
the last row, as NumPy's and JAX's indexing do) and clamps the rest
(``_take``); its gradient is ``scatter.gather``'s deterministic scatter.
``scatter.segment_sum`` drops ids outside [0, n), as ``jax.ops.segment_sum``
does; invalid edges (an id < 0) are masked by ``edge_valid`` and sent to
node 0 with zero weight.

Forces are ``-dE/dpositions`` through ``torch.autograd.grad``.  Under grad
mode the graph of that gradient is kept (``create_graph``), so a loss on
the forces can be differentiated again with respect to the parameters (the
double backward); under ``torch.no_grad`` the forces come back detached.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.models.gnn import mlp_apply, mlp_init
from repro_torch.models.layers import _init_dense
from repro_torch.models.scatter import gather, segment_sum
from repro_torch.models.transformer import ParamTree, _tensor


# --------------------------------------------------------------------------
# real spherical harmonics (cartesian, l <= 2), unit-normalized inputs
# --------------------------------------------------------------------------

def spherical_harmonics(vec, l_max: int) -> dict:
    """vec: (..., 3) unit vectors -> dict {l: (..., 2l+1)} real SH values.

    Component ordering follows m = -l..l in the real basis."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    out = {0: torch.full(vec.shape[:-1] + (1,), 0.5 / math.sqrt(math.pi),
                         dtype=vec.dtype, device=vec.device)}
    if l_max >= 1:
        c1 = math.sqrt(3.0 / (4.0 * math.pi))
        out[1] = c1 * torch.stack([y, z, x], dim=-1)
    if l_max >= 2:
        c = math.sqrt(15.0 / (4.0 * math.pi))
        c20 = math.sqrt(5.0 / (16.0 * math.pi))
        out[2] = torch.stack([
            c * x * y,
            c * y * z,
            c20 * (3 * z * z - 1.0),
            c * x * z,
            (c / 2.0) * (x * x - y * y),
        ], dim=-1)
    if l_max >= 3:
        raise NotImplementedError("l_max <= 2")
    return out


# --------------------------------------------------------------------------
# real Clebsch-Gordan coupling coefficients (host-side numpy, cached)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cg_complex(j1: int, j2: int, j3: int) -> np.ndarray:
    """Complex CG <j1 m1 j2 m2 | j3 m3> as (2j1+1, 2j2+1, 2j3+1) (Racah)."""
    f = math.factorial
    out = np.zeros((2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1))
    for i1, m1 in enumerate(range(-j1, j1 + 1)):
        for i2, m2 in enumerate(range(-j2, j2 + 1)):
            m3 = m1 + m2
            if abs(m3) > j3:
                continue
            i3 = m3 + j3
            pre = math.sqrt(
                (2 * j3 + 1) * f(j3 + j1 - j2) * f(j3 - j1 + j2)
                * f(j1 + j2 - j3) / f(j1 + j2 + j3 + 1))
            pre *= math.sqrt(f(j3 + m3) * f(j3 - m3) * f(j1 - m1)
                             * f(j1 + m1) * f(j2 - m2) * f(j2 + m2))
            s = 0.0
            for k in range(0, j1 + j2 - j3 + 1):
                denom_args = (k, j1 + j2 - j3 - k, j1 - m1 - k,
                              j2 + m2 - k, j3 - j2 + m1 + k, j3 - j1 - m2 + k)
                if any(a < 0 for a in denom_args):
                    continue
                s += (-1.0) ** k / np.prod([f(a) for a in denom_args])
            out[i1, i2, i3] = pre * s
    return out


@functools.lru_cache(maxsize=None)
def _real_basis_U(l: int) -> np.ndarray:
    """U s.t. |l m_real> = sum_m U[m_real, m] |l m_complex> (Condon-Shortley)."""
    dim = 2 * l + 1
    U = np.zeros((dim, dim), dtype=np.complex128)
    for mr in range(-l, l + 1):
        i = mr + l
        if mr == 0:
            U[i, l] = 1.0
        elif mr > 0:
            U[i, -mr + l] = 1.0 / math.sqrt(2)
            U[i, mr + l] = (-1.0) ** mr / math.sqrt(2)
        else:
            am = -mr
            U[i, -am + l] = 1j / math.sqrt(2)
            U[i, am + l] = -1j * (-1.0) ** am / math.sqrt(2)
    return U


@functools.lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling tensor w (2l1+1, 2l2+1, 2l3+1); may be zero."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    C = _cg_complex(l1, l2, l3).astype(np.complex128)
    U1, U2, U3 = _real_basis_U(l1), _real_basis_U(l2), _real_basis_U(l3)
    w = np.einsum("am,bn,co,mno->abc", U1, U2, U3.conj(), C)
    # the real-basis coupling is real or purely imaginary per (l1+l2+l3) parity
    if np.abs(w.imag).max() > np.abs(w.real).max():
        w = w.imag
    else:
        w = w.real
    w[np.abs(w) < 1e-12] = 0.0
    return np.ascontiguousarray(w)


@functools.lru_cache(maxsize=None)
def _cg_tensor(l1: int, l2: int, l3: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """``real_cg`` as a tensor of ``dtype`` on ``device`` (made once)."""
    return torch.as_tensor(real_cg(l1, l2, l3), dtype=dtype, device=device)


# --------------------------------------------------------------------------
# radial basis
# --------------------------------------------------------------------------

def bessel_basis(r, n_rbf: int, cutoff: float):
    """Sine-Bessel radial basis with smooth polynomial cutoff (NequIP eq. 8)."""
    r = torch.clamp(r, min=1e-9)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    b = math.sqrt(2.0 / cutoff) * torch.sin(
        n * math.pi * r[..., None] / cutoff) / r[..., None]
    # p=6 polynomial envelope (smooth to 2nd derivative at r=cutoff)
    u = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1.0 - 28 * u**6 + 48 * u**7 - 21 * u**8
    return b * env[..., None]


# --------------------------------------------------------------------------
# config + init
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    n_layers: int = 5
    channels: int = 32          # multiplicity per irrep order
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    d_scalar_in: int = 0        # optional extra l=0 scalar inputs (non-mol shapes)
    radial_hidden: int = 64

    @property
    def paths(self):
        """All allowed (l_in, l_filter, l_out) CG paths, l_filter/out <= l_max."""
        ps = []
        for l1 in range(self.l_max + 1):
            for l2 in range(self.l_max + 1):
                for l3 in range(abs(l1 - l2), min(l1 + l2, self.l_max) + 1):
                    if np.abs(real_cg(l1, l2, l3)).max() > 0:
                        ps.append((l1, l2, l3))
        return tuple(ps)


def nequip_init(generator: torch.Generator, cfg: NequIPConfig,
                device=None) -> ParamTree:
    """Random weights with the reference's distributions (species embedding
    N(0, 0.5²), dense N(0, 1/d_in), biases 0), drawn from ``generator``
    (which must live on ``device``); trainable.  Not the reference's
    numbers: ``params_from_reference`` carries those across."""
    C = cfg.channels
    n_paths = len(cfg.paths)
    g = dict(generator=generator, device=device)
    p = {
        "species_embed": torch.randn((cfg.n_species, C), **g) * 0.5,
        "readout1": _init_dense(d_in=C, d_out=C // 2, **g),
        "readout2": _init_dense(d_in=C // 2, d_out=1, **g),
        "layers": [],
    }
    if cfg.d_scalar_in:
        p["scalar_embed"] = _init_dense(d_in=cfg.d_scalar_in, d_out=C, **g)
    for _ in range(cfg.n_layers):
        p["layers"].append({
            # radial MLP -> one weight per (path, channel)
            "radial": mlp_init(dims=[cfg.n_rbf, cfg.radial_hidden,
                                     n_paths * C], **g),
            # per-l self-interaction + post-message linear
            "self": [_init_dense(d_in=C, d_out=C, **g)
                     for _ in range(cfg.l_max + 1)],
            "post": [_init_dense(d_in=C, d_out=C, **g)
                     for _ in range(cfg.l_max + 1)],
            # scalar gates for l>0 channels
            "gate": _init_dense(d_in=C, d_out=cfg.l_max * C, **g),
        })
    return ParamTree(p, trainable=True)


_TOP_KEYS = {"species_embed", "readout1", "readout2", "layers"}


def params_from_reference(tree: dict, device=None) -> ParamTree:
    """The reference's parameter tree (``repro.models.equivariant.
    nequip_init``), its leaves as numpy arrays, as trainable port
    parameters: the same keys and lists (``layers[i]["self"][l]``)."""
    keys = set(tree)
    if keys not in (_TOP_KEYS, _TOP_KEYS | {"scalar_embed"}):
        raise ValueError(f"nequip: the tree has keys {sorted(keys)}, "
                         f"expected {sorted(_TOP_KEYS)} (+ scalar_embed)")
    return ParamTree(T.tree_map(lambda a: _tensor(np.asarray(a), device),
                                tree), trainable=True)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with the reference's indexing: a negative id wraps
    (-1 is the last row), an id past either end is clamped."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return gather(table, idx)


def _interaction(lp, cfg: NequIPConfig, feats, sh, rbf_w, src, dst, n_nodes):
    """One NequIP interaction block. feats: {l: (N, C, 2l+1)}."""
    msgs = messages(cfg, feats, sh, rbf_w, src)
    return node_update(lp, cfg, feats, {
        l: None if m is None else segment_sum(m, dst, n_nodes)
        for l, m in msgs.items()})


def messages(cfg: NequIPConfig, feats, sh, rbf_w, src) -> dict:
    """An interaction block's edge side: per l the (E, C, 2l+1) messages
    (None where no path ends at l)."""
    msgs = {l: None for l in range(cfg.l_max + 1)}
    hj_of = {}                       # one gather a source order
    for pi, (l1, l2, l3) in enumerate(cfg.paths):
        w = _cg_tensor(l1, l2, l3, feats[0].dtype, feats[0].device)
        if l1 not in hj_of:
            hj_of[l1] = _take(feats[l1], src)                  # (E, C, d1)
        y = sh[l2]                                             # (E, d2)
        r = rbf_w[:, pi, :]                                    # (E, C)
        m = torch.einsum("ecx,ey,xyz->ecz", hj_of[l1], y, w)   # (E, C, d3)
        m = m * r[..., None]
        msgs[l3] = m if msgs[l3] is None else msgs[l3] + m
    return msgs


def node_update(lp, cfg: NequIPConfig, feats, aggs: dict) -> dict:
    """An interaction block's node side, from the messages summed into
    their destinations (``aggs``: per l (N, C, 2l+1), or None)."""
    C = cfg.channels
    out = {}
    for l in range(cfg.l_max + 1):
        agg = aggs[l] if aggs[l] is not None else torch.zeros_like(feats[l])
        selfi = torch.einsum("ncx,cd->ndx", feats[l], lp["self"][l])
        h = selfi + torch.einsum("ncx,cd->ndx", agg, lp["post"][l])
        out[l] = h
    # gate nonlinearity
    scal = out[0][..., 0]                                      # (N, C)
    gates = torch.sigmoid(scal @ lp["gate"])                   # (N, l_max*C)
    new = {0: F.silu(scal)[..., None]}
    for l in range(1, cfg.l_max + 1):
        g = gates[:, (l - 1) * C: l * C]
        new[l] = out[l] * g[..., None]
    # residual on scalars (NequIP resnet-style update)
    new[0] = new[0] + feats[0]
    return new


def embed_nodes(params, cfg: NequIPConfig, species, n_nodes,
                scalar_feats=None) -> dict:
    """The input features {l: (N, C, 2l+1)}: species (and scalar inputs)
    at l = 0, zeros above."""
    C = cfg.channels
    h0 = gather(params["species_embed"],
                torch.clamp(species, 0, cfg.n_species - 1))
    if scalar_feats is not None and "scalar_embed" in params:
        h0 = h0 + scalar_feats @ params["scalar_embed"]
    feats = {0: h0[..., None]}
    for l in range(1, cfg.l_max + 1):
        feats[l] = h0.new_zeros((n_nodes, C, 2 * l + 1))
    return feats


def edge_basis(cfg: NequIPConfig, positions, src, dst) -> tuple:
    """Per edge (spherical harmonics by l, the radial basis (E, n_rbf), the
    valid mask, dst with padding edges sent to node 0)."""
    rel = _take(positions, src) - _take(positions, dst)       # (E, 3)
    dist = torch.sqrt((rel * rel).sum(-1) + 1e-12)
    unit = rel / dist[..., None]
    sh = spherical_harmonics(unit, cfg.l_max)
    rbf = bessel_basis(dist, cfg.n_rbf, cfg.cutoff)            # (E, n_rbf)
    edge_valid = (src >= 0) & (dst >= 0)
    return sh, rbf, edge_valid, torch.where(edge_valid, dst, 0)


def radial_weights(lp, cfg: NequIPConfig, rbf, edge_valid):
    """A layer's per-(edge, path, channel) radial weights."""
    rw = mlp_apply(lp["radial"], rbf, act=F.silu)
    rw = rw.reshape(-1, len(cfg.paths), cfg.channels)
    return rw * edge_valid[:, None, None]


def readout(params, feats, node_mask=None):
    """Per-node energy (N,) from the l = 0 features."""
    e = F.silu(feats[0][..., 0] @ params["readout1"]) @ params["readout2"]
    e = e[..., 0]
    if node_mask is not None:
        e = e * node_mask
    return e


def nequip_apply(params, cfg: NequIPConfig, species, positions, src, dst,
                 n_nodes, scalar_feats=None, node_mask=None):
    """Per-node energy contributions.

    species: (N,) int; positions: (N, 3); src/dst: (E,) edges (messages
    flow src -> dst; an id < 0 marks a padding edge); scalar_feats:
    optional (N, d_scalar_in).  Returns per-node scalar energy (N,)."""
    feats = embed_nodes(params, cfg, species, n_nodes, scalar_feats)
    sh, rbf, edge_valid, dst_safe = edge_basis(cfg, positions, src, dst)
    for lp in params["layers"]:
        rw = radial_weights(lp, cfg, rbf, edge_valid)
        feats = _interaction(lp, cfg, feats, sh, rw, src, dst_safe, n_nodes)
    return readout(params, feats, node_mask)


def energy_and_forces(params, cfg: NequIPConfig, species, positions, src, dst,
                      n_nodes, **kw):
    """(total energy, forces ``-dE/dpositions`` (N, 3)).  Under grad mode
    the forces keep their graph, to be differentiated again."""
    keep = torch.is_grad_enabled()
    with torch.enable_grad():
        pos = positions if positions.requires_grad \
            else positions.detach().requires_grad_(True)
        e = nequip_apply(params, cfg, species, pos, src, dst, n_nodes,
                         **kw).sum()
        (neg_f,) = torch.autograd.grad(e, pos, create_graph=keep)
    if not keep:
        e = e.detach()
    return e, -neg_f


def energy_loss(params, cfg: NequIPConfig, batch, force_weight: float = 1.0):
    """MSE on energies (+ forces when labels present). batch holds flattened
    block-diagonal molecule graphs: species, positions, src, dst, graph_id,
    energy (G,), optional forces (N, 3), node_mask.  A ``graph_id`` outside
    [0, G) (the stream's sink) is dropped, as the reference's segment sum
    drops it."""
    n_nodes = batch["species"].shape[0]
    if "forces" in batch:
        e_node, f = energy_and_forces(
            params, cfg, batch["species"], batch["positions"], batch["src"],
            batch["dst"], n_nodes, node_mask=batch.get("node_mask"))
        fl = ((f - batch["forces"]) ** 2).sum(-1)
        if batch.get("node_mask") is not None:
            fl = fl * batch["node_mask"]
        floss = force_weight * fl.mean()
        # the reference sums the scalar total energy into every node's
        # graph (``segment_sum`` broadcasts a scalar over the ids)
        e_node = e_node.expand(n_nodes)
    else:
        e_node = nequip_apply(
            params, cfg, batch["species"], batch["positions"], batch["src"],
            batch["dst"], n_nodes, scalar_feats=batch.get("scalar_feats"),
            node_mask=batch.get("node_mask"))
        floss = 0.0
    n_graphs = batch["energy"].shape[0]
    e_graph = segment_sum(e_node, batch["graph_id"], n_graphs)
    return ((e_graph - batch["energy"]) ** 2).mean() + floss
