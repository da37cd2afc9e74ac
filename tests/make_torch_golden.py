"""Regenerate ``tests/torch_golden.json`` from the JAX reference package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_golden.py

The file ties the port's output on a GPU (``chip_smoke.py`` reads it there,
where JAX is not used) to the reference package's.  Per run of ``runs()`` —
``paper_suite("tiny")`` x seeds 0-2 with the default spec, with
``distance=2`` and with ``algorithm=`` each of the paper's baselines
``cat``, ``gm`` and ``jp``, and two bipartite graphs x seeds 0-2 with
``distance=2, mode="partial"`` — it holds the integer result fields of
``repro.api.color`` and a SHA-256 of ``colors.tobytes()`` (int32).  ``tests/test_torch_golden.py``
fails when the file is stale.

Two more sections hold the dynamic subsystem.  ``incremental``: per
``paper_suite("tiny")`` graph, ``api.color(g, mode="incremental",
**INC_OPTS)`` then ``STREAM_BATCHES`` batches of ``recolor_incremental``
(``stream_batches``: seed 0), with the state's ``INC_FIELDS`` and a colors
SHA-256 after each batch.  ``service``: one megabatched ``ColoringService``
of ``SVC_TENANTS`` tenants stepped ``SVC_STEPS`` times (``service_stream``),
with each tenant's ``summary()`` and colors SHA-256 after each step.

Two more hold the distributed engines, made on meshes of host devices.
``distributed``: ``paper_suite("tiny")`` x seeds 0-2 x ``rsoc`` / ``cat``
with ``backend="distributed"`` on meshes of ``DIST_SHARDS`` shards
(``dist_runs``).  ``sharded``: ``mesh2d(24, 24)`` through ``mode=
"incremental", backend="distributed"`` on the same meshes, then
``SHARD_BATCHES`` batches of ``recolor_sharded`` (``sharded_stream``), with
the state's ``SHARD_FIELDS`` and a colors SHA-256 after each.  The
reference needs ``XLA_FLAGS`` set before JAX is imported for a mesh of more
than one device, so ``main`` makes these two sections in a subprocess
(``reference_mesh_sections``) and the others exactly as before.

One more holds GNN training: ``gnn``.  ``losses``: the reference's
``launch.train.build_gnn`` smoke model of each of ``GNN_ARCHS`` on
``mesh2d(24, 24)``, its weights from ``gnn_leaf_values`` (one seeded
numpy stream, which both packages can make), ``GNN_STEPS`` steps of
``train_loop.run`` (``reference_gnn_losses``; ``port_gnn_losses`` is the
port's same run).  ``halo_loss``: the reference's ``gatedgcn_halo_loss``
under ``shard_map`` on the 256-vertex ring of ``tests/test_distributed.py``
at ``HALO_D`` shards (``halo_ring`` / ``halo_shards`` build its inputs
from a package's partition module; made in the mesh subprocess).

One more holds LM training: ``lm_train``.  Per LM smoke config of
``LM_ARCHS``: the ``LM_STEPS`` batches of ``TokenStream(LM_BATCH,
LM_SEQ)`` the reference draws, stored as tokens (``TokenStream``'s
``zipf`` draws differ between numpy versions, so a run elsewhere reads
them from the file: ``lm_batches``); weights from ``lm_leaf_values`` (one
seeded numpy stream); the first batch's loss and every leaf's gradient
(its largest magnitude, its value at ``LM_PICKS`` seeded flat indices and
at its largest element); then ``LM_STEPS`` steps of ``train_loop.run``
(``LM_MICROBATCHES`` microbatches) over the batches from the same
weights: the loss history and each leaf's value, after the steps, at the
element of its largest first gradient (where Adam's step has a definite
sign) (``reference_lm_train`` / ``port_lm_train``).  ``python
tests/make_torch_golden.py --lm-section`` adds or remakes this section
alone, leaving the others byte for byte.

One more holds the smoke ``nequip`` and ``dcn-v2``: ``models``.  Per arch
of ``MODELS_ARCHS``: the ``MODELS_STEPS`` batches its smoke stream draws,
stored (``models_draw``; a molecule batch without its sink -> sink
padding, which ``models_batches`` restores, and with a seeded ``forces``
label and ``node_mask``); weights from ``gnn_leaf_values``; the first
batch's forward, the whole gradient of one leaf (``MODELS_GRAD_LEAF``;
nequip's through the forces, a double backward) and ``MODELS_STEPS`` steps
of ``train_loop.run``'s losses (``reference_models`` / ``port_models``).
``python tests/make_torch_golden.py --models-section`` adds or remakes
this section alone, leaving the others byte for byte.
"""
import hashlib
import json
import os

import numpy as np

FIELDS = ("n_rounds", "total_conflicts", "final_C", "retries", "n_colors")
SEEDS = (0, 1, 2)
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_golden.json")


def entry(res) -> dict:
    d = {f: int(getattr(res, f)) for f in FIELDS}
    d["colors_sha256"] = hashlib.sha256(
        np.ascontiguousarray(res.colors, dtype=np.int32).tobytes()).hexdigest()
    return d


N_LEFT = 80      # left side of the bipartite graphs (mode="partial")
BASELINES = ("cat", "gm", "jp")   # the distance-1 engines beside RSOC


def runs(gen):
    """``(key, graph, spec overrides)`` of every golden entry; ``gen`` is a
    generators module (the reference's or the port's: same graphs)."""
    for name, g in gen.paper_suite("tiny").items():
        for seed in SEEDS:
            yield f"{name}/seed={seed}", g, dict(seed=seed)
            yield f"d2/{name}/seed={seed}", g, dict(seed=seed, distance=2)
            for algo in BASELINES:
                yield (f"{algo}/{name}/seed={seed}", g,
                       dict(seed=seed, algorithm=algo))
    bipartite = {"bipartite_random": gen.bipartite_random(N_LEFT, 50, 3.0,
                                                          seed=7),
                 "bipartite_banded": gen.bipartite_banded(N_LEFT, 50)}
    for name, g in bipartite.items():
        for seed in SEEDS:
            yield (f"partial/{name}/seed={seed}", g,
                   dict(seed=seed, distance=2, mode="partial", n_left=N_LEFT))


def compute(color, gen) -> dict:
    """``{key: entry}`` for a ``color(g, **overrides)`` callable."""
    return {key: entry(color(g, **kw)) for key, g, kw in runs(gen)}


def sha(colors) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        colors, dtype=np.int32).tobytes()).hexdigest()


# --------------------------------------------------------------------------
# the dynamic subsystem: incremental streams and a megabatched service
# --------------------------------------------------------------------------

INC_FIELDS = ("version", "last_rounds", "last_conflicts",
              "last_gather_passes", "C", "retries", "ovf_grows")
# ell_cap 16 spills the RMATs' hubs to the overflow buffer, delta_cap 32
# splits a batch into several waves
INC_OPTS = dict(seed=0, ell_cap=16, delta_cap=32)
STREAM_BATCHES = 10


def undirected(g) -> np.ndarray:
    """(m, 2) int64 u < v edges of a CSR graph (numpy only)."""
    src = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    e = np.stack([src, np.asarray(g.indices, np.int64)], axis=1)
    return e[e[:, 0] < e[:, 1]]


def stream_batches(g, n_batches: int = STREAM_BATCHES, seed: int = 0,
                   k: int = 24):
    """``n_batches`` (inserts, deletes) pairs: k random inserts (self-loops
    dropped) and k / 2 deletes drawn from the graph's own edges."""
    rng = np.random.default_rng(seed)
    und = undirected(g)
    out = []
    for _ in range(n_batches):
        ins = rng.integers(0, g.n_vertices, size=(k, 2))
        ins = ins[ins[:, 0] != ins[:, 1]]
        dels = und[rng.choice(len(und), size=min(k // 2, len(und)),
                              replace=False)]
        out.append((ins, dels))
    return out


def incremental_stream(color, recolor, g) -> list:
    """Per-batch entries of one graph's stream for a ``color(g, **kw)``
    front door and a ``recolor(state, ins, dels)`` of one package."""
    st = color(g, mode="incremental", **INC_OPTS).state
    rows = []
    for ins, dels in stream_batches(g):
        st = recolor(st, ins, dels)
        row = {f: int(getattr(st, f)) for f in INC_FIELDS}
        row["colors_sha256"] = sha(st.colors)
        rows.append(row)
    return rows


def incremental_entries(color, recolor, gen) -> dict:
    """``{graph: incremental_stream}`` over ``paper_suite("tiny")``."""
    return {name: incremental_stream(color, recolor, g)
            for name, g in gen.paper_suite("tiny").items()}


SVC_OPTS = dict(seed=0, n_chunks=2, ell_cap=12, C=32, ovf_cap=256,
                delta_cap=64, frontier_frac=0.5)
SVC_TENANTS, SVC_STEPS, SVC_N = 8, 2, 256


def service_stream(seed: int = 7):
    """``[step][tenant]`` lists of 4 (16 inserts, 8 deletes) batches."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(SVC_STEPS):
        per_t = []
        for _t in range(SVC_TENANTS):
            q = []
            for _b in range(4):
                ins = rng.integers(0, SVC_N, (16, 2))
                ins = ins[ins[:, 0] != ins[:, 1]]
                q.append((ins, rng.integers(0, SVC_N, (8, 2))))
            per_t.append(q)
        steps.append(per_t)
    return steps


def service_entries(svc, gen) -> list:
    """Per step, ``{tenant: summary + colors SHA-256}`` of a megabatched
    ``ColoringService`` (any package's, made by the caller) fed
    ``service_stream``."""
    for i in range(SVC_TENANTS):
        svc.add_graph(f"g{i}", gen.erdos_renyi(SVC_N, 8.0, seed=i))
    out = []
    for per_t in service_stream():
        for t, q in enumerate(per_t):
            for ins, dels in q:
                svc.submit(f"g{t}", inserts=ins, deletes=dels)
        svc.step()
        out.append({f"g{t}": dict(svc.stats(f"g{t}"),
                                  colors_sha256=sha(svc.colors(f"g{t}")))
                    for t in range(SVC_TENANTS)})
    return out


# --------------------------------------------------------------------------
# the distributed engines: static on meshes, and the sharded stream
# --------------------------------------------------------------------------

DIST_SHARDS = (1, 4)
DIST_ALGOS = ("rsoc", "cat")
SHARD_FIELDS = INC_FIELDS + ("replans", "last_halo_bytes",
                             "halo_bytes_per_round", "n_shards")
SHARD_BATCHES = 5


def dist_runs(gen):
    """``(key, graph, D, spec overrides)`` of every ``distributed`` entry."""
    for name, g in gen.paper_suite("tiny").items():
        for seed in SEEDS:
            for algo in DIST_ALGOS:
                for D in DIST_SHARDS:
                    yield (f"{algo}/{name}/seed={seed}/D={D}", g, D,
                           dict(seed=seed, algorithm=algo,
                                backend="distributed"))


def distributed_entries(color, mesh_of, gen) -> dict:
    """``{key: entry}`` of ``dist_runs`` for a package's ``color`` and a
    ``mesh_of(D)`` maker of its meshes."""
    return {key: entry(color(g, mesh=mesh_of(D), **kw))
            for key, g, D, kw in dist_runs(gen)}


def sharded_stream(color, recolor, mesh_of, gen) -> dict:
    """``{"D=<D>": per-batch rows}``: ``mesh2d(24, 24)`` encoded over
    ``mesh_of(D)``, then ``SHARD_BATCHES`` batches (40 inserts, 15
    deletes; seed 7) of a package's ``recolor_sharded``."""
    g = gen.mesh2d(24, 24)
    out = {}
    for D in DIST_SHARDS:
        st = color(g, mode="incremental", backend="distributed",
                   mesh=mesh_of(D), seed=0).state
        rng = np.random.default_rng(7)
        rows = []
        for _ in range(SHARD_BATCHES):
            ins = rng.integers(0, g.n_vertices, size=(40, 2))
            dels = rng.integers(0, g.n_vertices, size=(15, 2))
            st = recolor(st, ins[ins[:, 0] != ins[:, 1]], dels)
            row = {f: int(getattr(st, f)) for f in SHARD_FIELDS}
            row["colors_sha256"] = sha(st.colors)
            rows.append(row)
        out[f"D={D}"] = rows
    return out


# --------------------------------------------------------------------------
# GNN training: the smoke models' loss histories and the halo GatedGCN
# --------------------------------------------------------------------------

GNN_ARCHS = ("gat-cora", "meshgraphnet", "gatedgcn")
GNN_STEPS = 6
# the launcher's optimizer at --steps 6 (warmup max(6 // 10, 1))
GNN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=GNN_STEPS)
HALO_N = 256          # the reference's ring (tests/test_distributed.py)
HALO_D = 4
HALO_CFG = dict(n_layers=3, d_hidden=8, d_in=6, d_out=3)


def gnn_leaf_values(paths_shapes) -> dict:
    """``{path: float32 array}`` for a parameter tree given as ``[(path,
    shape)]`` in JAX's leaf order, from one seeded numpy stream, so both
    packages start from the same weights: a matrix N(0, 1 / rows), a
    layer norm's scale 1, every other vector 0."""
    rng = np.random.default_rng(0)
    out = {}
    for path, shape in paths_shapes:
        if len(shape) >= 2:
            out[path] = (rng.standard_normal(shape)
                         / np.sqrt(shape[0])).astype(np.float32)
        elif path.endswith("['ln_scale']"):
            out[path] = np.ones(shape, np.float32)
        else:
            out[path] = np.zeros(shape, np.float32)
    return out


def reference_gnn_losses() -> dict:
    """``{arch: losses}``: the reference's ``repro.launch.train.build_gnn``
    smoke model of each of ``GNN_ARCHS`` on ``mesh2d(24, 24)`` (weights
    from ``gnn_leaf_values``), ``GNN_STEPS`` steps of its ``TL.run``."""
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.launch.train import build_gnn
    from repro.training import train_loop as TL
    from repro.training.optimizer import OptimizerConfig

    out = {}
    for arch in GNN_ARCHS:
        params, stream, loss = build_gnn(configs.get(arch), True, 8)
        flat, tdef = jax.tree_util.tree_flatten_with_path(params)
        paths = [jax.tree_util.keystr(p) for p, _ in flat]
        vals = gnn_leaf_values([(k, np.shape(x))
                                for k, (_, x) in zip(paths, flat)])
        params = jax.tree_util.tree_unflatten(
            tdef, [jnp.asarray(vals[k]) for k in paths])
        _, _, hist = TL.run(
            loss, params, stream, OptimizerConfig(**GNN_OPT),
            TL.TrainLoopConfig(total_steps=GNN_STEPS, log_every=1),
            to_device=lambda b: jax.tree.map(jnp.asarray, b))
        out[arch] = [h["loss"] for h in hist]
    return out


def port_gnn_losses(device) -> dict:
    """``reference_gnn_losses`` of the port on ``device``."""
    import torch
    from repro_torch import configs
    from repro_torch import tree
    from repro_torch.launch.train import build_gnn, to_device
    from repro_torch.training import train_loop as TL
    from repro_torch.training.optimizer import OptimizerConfig

    out = {}
    for arch in GNN_ARCHS:
        params, stream, loss = build_gnn(configs.get(arch), device)
        flat = tree.flatten_with_paths(params)
        vals = gnn_leaf_values([(k, tuple(x.shape)) for k, x in flat])
        with torch.no_grad():
            for k, x in flat:
                x.copy_(torch.from_numpy(vals[k]))
        _, _, hist = TL.run(
            loss, params, stream, OptimizerConfig(**GNN_OPT),
            TL.TrainLoopConfig(total_steps=GNN_STEPS, log_every=1),
            to_device=lambda b: to_device(b, device))
        out[arch] = [h["loss"] for h in hist]
    return out


LM_ARCHS = ("qwen3-1.7b", "qwen3-32b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
            "qwen2-moe-a2.7b")
LM_BATCH, LM_SEQ = 4, 64
LM_STEPS, LM_MICROBATCHES = 3, 2
LM_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=LM_STEPS)
LM_PICKS = 4


def lm_leaf_values(paths_shapes) -> dict:
    """``{path: float32 array}`` of an LM parameter tree given as ``[(path,
    shape)]`` in JAX's leaf order (``layers`` stacked), from one seeded
    numpy stream: the embedding N(0, 0.02²), a norm's scale 1, a (stacked)
    dense weight N(0, 1 / d_in)."""
    rng = np.random.default_rng(0)
    out = {}
    for path, shape in paths_shapes:
        if path.endswith("['scale']"):
            out[path] = np.ones(shape, np.float32)
        elif path.endswith("['table']"):
            out[path] = (rng.standard_normal(shape) * 0.02).astype(
                np.float32)
        else:
            out[path] = (rng.standard_normal(shape)
                         / np.sqrt(shape[-2])).astype(np.float32)
    return out


def lm_batches(tokens) -> list:
    """The stored ``(LM_BATCH, LM_SEQ + 1)`` token arrays as
    ``TokenStream`` batches (``tokens`` all but the last, ``labels`` all but
    the first)."""
    out = []
    for t in tokens:
        t = np.asarray(t, np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def lm_summary(tokens, loss, grads, losses, after) -> dict:
    """The ``lm_train`` entry of one arch: ``tokens`` the batches' token
    arrays, ``grads`` and ``after`` ``[(path, numpy array)]`` in leaf order
    (the first gradient, the parameters after the steps)."""
    rng = np.random.default_rng(1)
    grad, post = {}, {}
    for (path, g), (path2, p) in zip(grads, after, strict=True):
        assert path == path2, (path, path2)
        flat = np.asarray(g, np.float32).ravel()
        top = int(np.argmax(np.abs(flat)))
        idx = [int(i) for i in rng.integers(0, flat.size, LM_PICKS)] + [top]
        grad[path] = {"absmax": float(np.abs(flat).max()), "index": idx,
                      "values": [float(flat[i]) for i in idx]}
        post[path] = float(np.asarray(p, np.float32).ravel()[top])
    return {"tokens": [np.asarray(t).tolist() for t in tokens],
            "loss": float(loss), "grad": grad, "losses": list(losses),
            "after_steps": post}


def reference_lm_train() -> dict:
    """``{arch: lm_summary}`` of the reference (see the module doc)."""
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.data import pipeline as DP
    from repro.models import transformer as TF
    from repro.training import train_loop as TL
    from repro.training.optimizer import OptimizerConfig

    out = {}
    for arch in LM_ARCHS:
        cfg = configs.get(arch).make_smoke()
        params = TF.init_params(jax.random.PRNGKey(0), cfg)
        flat, tdef = jax.tree_util.tree_flatten_with_path(params)
        paths = [jax.tree_util.keystr(p) for p, _ in flat]
        vals = lm_leaf_values([(k, np.shape(x))
                               for k, (_, x) in zip(paths, flat)])
        params = jax.tree_util.tree_unflatten(
            tdef, [jnp.asarray(vals[k]) for k in paths])
        loss_fn = jax.jit(lambda p, b, cfg=cfg: TF.train_step_loss(p, cfg, b))
        stream = DP.TokenStream(batch=LM_BATCH, seq_len=LM_SEQ,
                                vocab=cfg.vocab)
        drawn = [next(stream) for _ in range(LM_STEPS)]
        tokens = [np.concatenate([b["tokens"], b["labels"][:, -1:]], 1)
                  for b in drawn]
        batches = lm_batches(tokens)
        loss, g = jax.value_and_grad(loss_fn)(
            params, jax.tree.map(jnp.asarray, batches[0]))
        grads = [(k, np.asarray(x)) for k, x in
                 zip(paths, jax.tree_util.tree_leaves(g))]
        new, _, hist = TL.run(
            loss_fn, params, iter(batches), OptimizerConfig(**LM_OPT),
            TL.TrainLoopConfig(total_steps=LM_STEPS, log_every=1,
                               microbatches=LM_MICROBATCHES),
            to_device=lambda b: jax.tree.map(jnp.asarray, b))
        after = [(k, np.asarray(x)) for k, x in
                 zip(paths, jax.tree_util.tree_leaves(new))]
        out[arch] = lm_summary(tokens, loss, grads,
                               [h["loss"] for h in hist], after)
    return out


def port_lm_train(device, section: dict) -> dict:
    """``reference_lm_train`` of the port on ``device``, over the batches
    stored in ``section`` (the file's ``lm_train``)."""
    import torch
    from repro_torch import configs
    from repro_torch import tree
    from repro_torch.launch.train import to_device
    from repro_torch.models import transformer as TF
    from repro_torch.training import train_loop as TL
    from repro_torch.training.optimizer import OptimizerConfig

    out = {}
    for arch in LM_ARCHS:
        cfg = configs.get(arch).make_smoke()
        params = TF.init_params(torch.Generator(device=device).manual_seed(0),
                                cfg, device, trainable=True)
        flat = tree.flatten_with_paths(params)
        vals = lm_leaf_values([(k, tuple(x.shape)) for k, x in flat])
        with torch.no_grad():
            for k, x in flat:
                x.copy_(torch.from_numpy(vals[k]))
        tokens = section[arch]["tokens"]
        batches = lm_batches(tokens)
        loss = TF.train_step_loss(params, cfg, to_device(batches[0], device))
        g = torch.autograd.grad(loss, tree.leaves(params))
        grads = [(k, x.detach().cpu().numpy()) for (k, _), x in zip(flat, g)]
        _, _, hist = TL.run(
            lambda p, b: TF.train_step_loss(p, cfg, b), params,
            iter(batches), OptimizerConfig(**LM_OPT),
            TL.TrainLoopConfig(total_steps=LM_STEPS, log_every=1,
                               microbatches=LM_MICROBATCHES),
            to_device=lambda b: to_device(b, device))
        after = [(k, x.detach().cpu().numpy()) for k, x in flat]
        out[arch] = lm_summary(tokens, loss.detach().cpu(), grads,
                               [h["loss"] for h in hist], after)
    return out


# --------------------------------------------------------------------------
# nequip and dcn-v2: the smoke models' forward, one gradient, three steps
# --------------------------------------------------------------------------

MODELS_ARCHS = ("nequip", "dcn-v2")
MODELS_STEPS = 3
MODELS_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=MODELS_STEPS)
MOL_STREAM = dict(n_nodes=6, n_edges=12, batch=3)   # + sink, 8192 edges
DCN_BATCH = 16
# the leaf whose whole gradient the section keeps
MODELS_GRAD_LEAF = {"nequip": "['species_embed']", "dcn-v2": "['mlp_w'][1]"}


def models_draw(arch: str, dp) -> list:
    """The ``MODELS_STEPS`` batches of ``arch``'s smoke stream (``dp``: a
    package's ``data.pipeline``) in the section's stored form: lists, and a
    molecule batch's edges without the sink -> sink padding, with a
    ``forces`` label and a ``node_mask`` (0 on the sink) from seed 3."""
    out = []
    if arch == "nequip":
        stream = dp.MoleculeStream(n_species=4, d_feat=0, **MOL_STREAM)
        n_real = MOL_STREAM["batch"] * MOL_STREAM["n_edges"]
        rng = np.random.default_rng(3)
        for _ in range(MODELS_STEPS):
            b = next(stream)
            n = b["species"].shape[0]
            assert (b["src"][n_real:] == n - 1).all()
            mask = np.ones(n, np.float32)
            mask[-1] = 0.0
            out.append({
                "positions": b["positions"].tolist(),
                "species": b["species"].tolist(),
                "src": b["src"][:n_real].tolist(),
                "dst": b["dst"][:n_real].tolist(),
                "n_edges_padded": int(b["src"].shape[0]),
                "graph_id": b["graph_id"].tolist(),
                "energy": b["energy"].tolist(),
                "forces": rng.standard_normal((n, 3)).astype(
                    np.float32).tolist(),
                "node_mask": mask.tolist()})
        return out
    stream = dp.RecsysStream(batch=DCN_BATCH, n_dense=13, n_sparse=6,
                             vocabs=[1000] * 6, max_hots=2)
    for _ in range(MODELS_STEPS):
        out.append({k: v.tolist() for k, v in next(stream).items()})
    return out


def models_batches(arch: str, stored: list) -> list:
    """The stored batches as numpy stream batches (a molecule batch's
    sink -> sink padding restored); the ``forces`` label and ``node_mask``
    are kept apart: ``(batch, extra)`` pairs."""
    out = []
    for e in stored:
        if arch == "nequip":
            n = len(e["species"])
            pad = e["n_edges_padded"] - len(e["src"])
            b = {"positions": np.asarray(e["positions"], np.float32),
                 "species": np.asarray(e["species"], np.int32),
                 "src": np.asarray(e["src"] + [n - 1] * pad, np.int32),
                 "dst": np.asarray(e["dst"] + [n - 1] * pad, np.int32),
                 "graph_id": np.asarray(e["graph_id"], np.int32),
                 "energy": np.asarray(e["energy"], np.float32)}
            extra = {"forces": np.asarray(e["forces"], np.float32),
                     "node_mask": np.asarray(e["node_mask"], np.float32)}
        else:
            b = {"dense": np.asarray(e["dense"], np.float32),
                 "sparse": np.asarray(e["sparse"], np.int32),
                 "labels": np.asarray(e["labels"], np.int32)}
            extra = {}
        out.append((b, extra))
    return out


def models_summary(stored, forward, grad, losses) -> dict:
    """The ``models`` entry of one arch: the stored batches, the first
    batch's forward, the whole gradient of its ``MODELS_GRAD_LEAF`` (with
    its largest magnitude), the loss history."""
    g = np.asarray(grad, np.float32)
    return {"batches": stored,
            "forward": np.asarray(forward, np.float32).ravel().tolist(),
            "grad": {"values": g.ravel().tolist(),
                     "absmax": float(np.abs(g).max())},
            "losses": [float(x) for x in losses]}


def reference_models() -> dict:
    """``{arch: models_summary}`` of the reference for ``MODELS_ARCHS``: the
    smoke config, weights from ``gnn_leaf_values``; the first batch's
    forward (nequip: per-node energies, the sink's masked: its 8,156
    self-loops make it thousands of times the others; dcn-v2: logits), the
    gradient of
    the loss (nequip: ``energy_loss`` with the ``forces`` label and
    ``node_mask``, a double backward; dcn-v2: ``ctr_loss``) at
    ``MODELS_GRAD_LEAF``, then ``MODELS_STEPS`` steps of ``train_loop.run``
    over the batches (nequip: ``energy_loss`` without forces, as the
    launcher trains)."""
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.data import pipeline as DP
    from repro.models import equivariant as EQ
    from repro.models import recsys as RS
    from repro.training import train_loop as TL
    from repro.training.optimizer import OptimizerConfig

    out = {}
    for arch in MODELS_ARCHS:
        cfg = configs.get(arch).make_smoke()
        if arch == "nequip":
            params = EQ.nequip_init(jax.random.PRNGKey(0), cfg)
            fwd = jax.jit(lambda p, b, cfg=cfg: EQ.nequip_apply(
                p, cfg, b["species"], b["positions"], b["src"], b["dst"],
                b["species"].shape[0], node_mask=b["node_mask"]))
            loss_fn = jax.jit(lambda p, b, cfg=cfg: EQ.energy_loss(p, cfg, b))
        else:
            params = RS.dcnv2_init(jax.random.PRNGKey(0), cfg)
            fwd = jax.jit(lambda p, b, cfg=cfg: RS.dcnv2_forward(
                p, cfg, b["dense"], b["sparse"]))
            loss_fn = jax.jit(lambda p, b, cfg=cfg: RS.ctr_loss(p, cfg, b))
        flat, tdef = jax.tree_util.tree_flatten_with_path(params)
        paths = [jax.tree_util.keystr(p) for p, _ in flat]
        vals = gnn_leaf_values([(k, np.shape(x))
                                for k, (_, x) in zip(paths, flat)])
        params = jax.tree_util.tree_unflatten(
            tdef, [jnp.asarray(vals[k]) for k in paths])
        stored = models_draw(arch, DP)
        batches = models_batches(arch, stored)
        b0, extra = batches[0]
        b0 = jax.tree.map(jnp.asarray, dict(b0, **extra))
        g = jax.grad(loss_fn)(params, b0)
        grad = dict(zip(paths, jax.tree_util.tree_leaves(g)))[
            MODELS_GRAD_LEAF[arch]]
        forward = np.asarray(fwd(params, b0))   # the run donates params
        _, _, hist = TL.run(
            loss_fn, params, iter([b for b, _ in batches]),
            OptimizerConfig(**MODELS_OPT),
            TL.TrainLoopConfig(total_steps=MODELS_STEPS, log_every=1),
            to_device=lambda b: jax.tree.map(jnp.asarray, b))
        out[arch] = models_summary(stored, forward, grad,
                                   [h["loss"] for h in hist])
    return out


def port_models(device, section: dict) -> dict:
    """``reference_models`` of the port on ``device``, over the batches
    stored in ``section`` (the file's ``models``)."""
    import torch
    from repro_torch import configs
    from repro_torch import tree
    from repro_torch.launch.train import to_device
    from repro_torch.models import equivariant as EQ
    from repro_torch.models import recsys as RS
    from repro_torch.training import train_loop as TL
    from repro_torch.training.optimizer import OptimizerConfig

    out = {}
    for arch in MODELS_ARCHS:
        cfg = configs.get(arch).make_smoke()
        gen = torch.Generator(device=device).manual_seed(0)
        if arch == "nequip":
            params = EQ.nequip_init(gen, cfg, device)

            def fwd(p, b, cfg=cfg):
                return EQ.nequip_apply(p, cfg, b["species"], b["positions"],
                                       b["src"], b["dst"],
                                       b["species"].shape[0],
                                       node_mask=b["node_mask"])

            def loss_fn(p, b, cfg=cfg):
                return EQ.energy_loss(p, cfg, b)
        else:
            params = RS.dcnv2_init(gen, cfg, device)

            def fwd(p, b, cfg=cfg):
                return RS.dcnv2_forward(p, cfg, b["dense"], b["sparse"])

            def loss_fn(p, b, cfg=cfg):
                return RS.ctr_loss(p, cfg, b)
        flat = tree.flatten_with_paths(params)
        vals = gnn_leaf_values([(k, tuple(x.shape)) for k, x in flat])
        with torch.no_grad():
            for k, x in flat:
                x.copy_(torch.from_numpy(vals[k]))
        stored = section[arch]["batches"]
        batches = models_batches(arch, stored)
        b0, extra = batches[0]
        b0 = to_device(dict(b0, **extra), device)
        loss = loss_fn(params, b0)
        leaf = dict(flat)[MODELS_GRAD_LEAF[arch]]
        (grad,) = torch.autograd.grad(loss, [leaf])
        with torch.no_grad():
            forward = fwd(params, b0).cpu()
        _, _, hist = TL.run(
            loss_fn, params, iter([b for b, _ in batches]),
            OptimizerConfig(**MODELS_OPT),
            TL.TrainLoopConfig(total_steps=MODELS_STEPS, log_every=1),
            to_device=lambda b: to_device(b, device))
        out[arch] = models_summary(stored, forward, grad.cpu(),
                                   [h["loss"] for h in hist])
    return out


def write(doc: dict) -> None:
    with open(PATH, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def halo_ring(partition, csr):
    """The halo GatedGCN's inputs on the reference's ring, as numpy
    (``partition`` and ``csr`` are a package's ``core.partition`` and
    ``graphs.csr``): the partition, the per-shard batches
    (``halo_shards``) and the replicated graph's (src, dst, feats, labels,
    mask) over ``n_pad`` relabeled nodes."""
    ring = np.stack([np.arange(HALO_N), (np.arange(HALO_N) + 1) % HALO_N], 1)
    part = partition.block_partition(csr.from_edges(HALO_N, ring), HALO_D,
                                     seed=0)
    plan = partition.build_halo(part)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((part.n_pad, HALO_CFG["d_in"])).astype(
        np.float32)
    labels = rng.integers(0, HALO_CFG["d_out"], part.n_pad).astype(np.int32)
    mask = np.ones(part.n_pad, np.float32)
    e = csr.to_edge_list(part.graph)
    replicated = (e[:, 0].astype(np.int32), e[:, 1].astype(np.int32), feats,
                  labels, mask)
    return part, halo_shards(part, plan, feats, labels, mask), replicated


def halo_shards(part, plan, feats, labels, mask) -> list:
    """Shard d's batch of the halo GatedGCN (numpy): its owned rows of the
    global ``feats`` / ``labels`` / ``mask`` (block partition), its ELL's
    live slots as (src, dst) edges — src a local slot or a ghost slot
    n_loc + g — its boundary list, and each ghost's index into the
    gathered (D * max_b,) boundary payload."""
    n_loc = part.n_loc
    W = plan.ell_local.shape[-1]
    ghost_flat = np.where(plan.ghost_owner >= 0,
                          plan.ghost_owner * plan.max_b + plan.ghost_slot,
                          -1).astype(np.int32)
    out = []
    for d in range(part.n_shards):
        srcs = plan.ell_local[d].reshape(-1)
        dsts = np.repeat(np.arange(n_loc, dtype=np.int32), W)
        keep = srcs >= 0
        rows = slice(d * n_loc, (d + 1) * n_loc)
        out.append({"feats": feats[rows], "labels": labels[rows],
                    "train_mask": mask[rows],
                    "src": srcs[keep].astype(np.int32),
                    "dst": dsts[keep],
                    "boundary": plan.boundary[d].astype(np.int32),
                    "ghost_flat": ghost_flat[d]})
    return out


def reference_halo_loss() -> float:
    """The reference's ``gatedgcn_halo_loss`` on the ring at ``HALO_D``
    shards under ``shard_map`` (needs ``HALO_D`` host devices)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.core import partition
    from repro.graphs import csr
    from repro.models import gnn as GNN

    _, shards, _ = halo_ring(partition, csr)
    cfg = GNN.GatedGCNConfig(**HALO_CFG)
    params = GNN.gatedgcn_init(jax.random.PRNGKey(0), cfg)
    flat, tdef = jax.tree_util.tree_flatten_with_path(params)
    paths = [jax.tree_util.keystr(p) for p, _ in flat]
    vals = gnn_leaf_values([(k, np.shape(x))
                            for k, (_, x) in zip(paths, flat)])
    params = jax.tree_util.tree_unflatten(
        tdef, [jnp.asarray(vals[k]) for k in paths])
    if len({len(s["src"]) for s in shards}) != 1:
        raise ValueError("shard_map needs equal edge counts a shard")
    batch = {k: jnp.asarray(np.concatenate([s[k] for s in shards]))
             for k in shards[0]}
    mesh = jax.make_mesh((HALO_D,), ("data",))
    loss = shard_map(
        lambda p, b: GNN.gatedgcn_halo_loss(p, cfg, b, ("data",), HALO_D),
        mesh=mesh, in_specs=(P(), {k: P("data") for k in batch}),
        out_specs=P(), check_rep=False)
    return float(loss(params, batch))


def mesh_sections() -> dict:
    """The reference's ``distributed`` and ``sharded`` sections and the
    halo GatedGCN's loss on the ring (in a process whose JAX sees
    ``max(DIST_SHARDS)`` host devices)."""
    import jax
    from repro import api
    from repro.dynamic import recolor_sharded
    from repro.graphs import generators

    meshes = {D: jax.make_mesh((D,), ("data",)) for D in DIST_SHARDS}
    return {"distributed": distributed_entries(api.color, meshes.get,
                                               generators),
            "sharded": sharded_stream(api.color, recolor_sharded,
                                      meshes.get, generators),
            "halo_loss": reference_halo_loss()}


def start_mesh_sections():
    """Start ``mesh_sections()`` in a subprocess of this file that sets
    ``XLA_FLAGS`` before JAX is imported; ``finish_mesh_sections`` reads
    it.  (A caller may do other work meanwhile.)"""
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(PATH)), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{max(DIST_SHARDS)}")
    env.pop("REPRO_FAULTS", None)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--mesh-sections"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def finish_mesh_sections(proc, timeout: float = 900) -> dict:
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(err[-3000:])
    return json.loads(out.strip().splitlines()[-1])


def reference_mesh_sections() -> dict:
    """``mesh_sections()`` of the reference, made in a subprocess."""
    return finish_mesh_sections(start_mesh_sections())


def main() -> None:
    from repro import api
    from repro.dynamic import ColoringService, recolor_incremental
    from repro.graphs import generators
    mesh = reference_mesh_sections()
    doc = {"generated_by": "tests/make_torch_golden.py (repro.api.color, "
                           "paper_suite('tiny') x seeds 0-2 at distance 1 "
                           "and 2 and with cat / gm / jp, bipartite partial "
                           "x seeds 0-2; incremental streams on "
                           "paper_suite('tiny'); a megabatched service; "
                           "rsoc / cat on meshes of 1 and 4 shards x "
                           "paper_suite('tiny') x seeds 0-2; sharded "
                           "streams on mesh2d(24, 24); 6 training steps of "
                           "each GNN smoke model on mesh2d(24, 24) and the "
                           "halo GatedGCN's loss on a 256-vertex ring at 4 "
                           "shards)",
           "results": compute(api.color, generators),
           "incremental": incremental_entries(api.color, recolor_incremental,
                                              generators),
           "service": service_entries(
               ColoringService(megabatch=True, **SVC_OPTS), generators),
           "distributed": mesh["distributed"], "sharded": mesh["sharded"],
           "gnn": {"losses": reference_gnn_losses(),
                   "halo_loss": mesh["halo_loss"]},
           "lm_train": reference_lm_train(),
           "models": reference_models()}
    write(doc)
    print(f"wrote {PATH} ({len(doc['results'])} entries, "
          f"{len(doc['incremental'])} incremental streams, "
          f"{len(doc['service'])} service steps, "
          f"{len(doc['distributed'])} distributed entries, "
          f"{len(doc['sharded'])} sharded streams, "
          f"{len(doc['gnn']['losses'])} GNN loss histories)")


if __name__ == "__main__":
    import sys
    if sys.argv[1:] == ["--mesh-sections"]:
        print(json.dumps(mesh_sections()))
    elif sys.argv[1:] == ["--models-section"]:
        with open(PATH) as f:
            doc = json.load(f)
        doc["models"] = reference_models()
        write(doc)
        print(f"wrote the models section of {PATH} "
              f"({len(doc['models'])} smoke models)")
    elif sys.argv[1:] == ["--lm-section"]:
        with open(PATH) as f:
            doc = json.load(f)
        doc["lm_train"] = reference_lm_train()
        write(doc)
        print(f"wrote the lm_train section of {PATH} "
              f"({len(doc['lm_train'])} LM smoke configs)")
    else:
        main()
