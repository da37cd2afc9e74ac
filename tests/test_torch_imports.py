"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the reference package ``repro``."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")

# `import jax`, `from jax...`, `import repro`, `from repro...` — `repro` as a
# whole word, so `repro_torch` does not match
FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)\b(?!_)|from\s+(?:jax|repro)\b(?!_))",
    re.MULTILINE)


def _py_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    import repro_torch
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    # sub-packages without an __init__ (namespace packages) are not walked
    for d, _, files in os.walk(PKG):
        rel = os.path.relpath(d, SRC).replace(os.sep, ".")
        for f in files:
            if f.endswith(".py") and f != "__init__.py":
                names.append(f"{rel}.{f[:-3]}")
    return sorted(set(names))


def test_regex_is_sound():
    assert FORBIDDEN.search("import jax\n")
    assert FORBIDDEN.search("  from jax.numpy import x\n")
    assert FORBIDDEN.search("from repro.core import bitset\n")
    assert FORBIDDEN.search("import repro\n")
    assert FORBIDDEN.search("from repro import api\n")
    assert not FORBIDDEN.search("from repro_torch.core import bitset\n")
    assert not FORBIDDEN.search("import repro_torch\n")
    assert not FORBIDDEN.search("# replaces src/repro/kernels/firstfit.py\n")


@pytest.mark.parametrize("path", _py_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_has_no_jax_or_reference_import(path):
    with open(path) as f:
        hit = FORBIDDEN.search(f.read())
    assert hit is None, f"{path}: {hit.group(0).strip()!r}"


def test_every_module_is_found():
    mods = _modules()
    for m in ("repro_torch.api", "repro_torch.registry",
              "repro_torch.core.bitset", "repro_torch.core.coloring",
              "repro_torch.core.context", "repro_torch.core.distance2",
              "repro_torch.core.frontier", "repro_torch.core.schedule",
              "repro_torch.graphs.csr",
              "repro_torch.graphs.generators", "repro_torch.kernels._build",
              "repro_torch.kernels.firstfit",
              "repro_torch.kernels.detect_recolor",
              "repro_torch.kernels.twohop", "repro_torch.kernels.ops",
              "repro_torch.kernels.ref", "repro_torch.obs.export",
              "repro_torch.obs.metrics", "repro_torch.obs.trace",
              "repro_torch.resilience.errors", "repro_torch.resilience.faults",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.ell_spmm", "repro_torch.models",
              "repro_torch.models.layers", "repro_torch.models.transformer",
              "repro_torch.configs", "repro_torch.configs.common",
              "repro_torch.configs.qwen3_1_7b", "repro_torch.serving",
              "repro_torch.serving.serve_loop", "repro_torch.launch",
              "repro_torch.launch.serve", "repro_torch.benchmarks",
              "repro_torch.benchmarks.staged_ablation",
              "repro_torch.benchmarks.ell_spmm_ab",
              "repro_torch.benchmarks.compact_pass_ab",
              "repro_torch.benchmarks.attention_sm90_ab", "repro_torch.dynamic",
              "repro_torch.dynamic.delta", "repro_torch.dynamic.incremental",
              "repro_torch.dynamic.megabatch",
              "repro_torch.dynamic.service",
              "repro_torch.dynamic.sharded", "repro_torch.core.mesh",
              "repro_torch.core.partition",
              "repro_torch.core.distributed",
              "repro_torch.resilience.ladder",
              "repro_torch.resilience.quarantine", "repro_torch.tree",
              "repro_torch.training", "repro_torch.training.optimizer",
              "repro_torch.training.checkpoint",
              "repro_torch.training.elastic",
              "repro_torch.training.train_loop", "repro_torch.data",
              "repro_torch.data.pipeline", "repro_torch.graphs.sampler",
              "repro_torch.models.gnn", "repro_torch.configs.gat_cora",
              "repro_torch.configs.gatedgcn",
              "repro_torch.configs.meshgraphnet",
              "repro_torch.launch.train", "repro_torch.configs.qwen3_32b",
              *MODELS_MODULES):
        assert m in mods, m


@pytest.mark.parametrize("first", [
    "repro_torch.kernels.firstfit", "repro_torch.kernels.detect_recolor",
    "repro_torch.kernels.twohop", "repro_torch.kernels.ell_spmm",
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.ops",
    "repro_torch.kernels.ref", "repro_torch.core.coloring"])
def test_any_kernel_module_imports_first(first):
    """A program may import any of the wrappers first: the wrappers, the
    plain versions and the engines import one another, and no order may
    find a module half made (each wrapper's names are read at call time by
    ``ops``, and ``firstfit`` imports nothing of core at import time)."""
    code = (f"import {first}\n"
            "from repro_torch.kernels import ops\n"
            "import torch\n"
            "ell = torch.tensor([[1, -1], [0, -1]], dtype=torch.int32)\n"
            "c = torch.tensor([0, 1], dtype=torch.int32)\n"
            "mex, ovf = ops.firstfit(ell, c, 32)\n"
            "assert mex.tolist() == [0, 1] and not ovf.any()\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_FAULTS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("first", [
    "repro_torch.core.mesh", "repro_torch.core.partition",
    "repro_torch.core.distributed", "repro_torch.dynamic.sharded"])
def test_distributed_module_imports_first(first):
    """Each module of the distributed slice imports first in a fresh
    interpreter, pulls in neither ``jax`` nor the reference package, and
    leaves the registry with the reference's whole support matrix."""
    code = (f"import {first}\n"
            "import sys\n"
            "from repro_torch import api\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "assert len(api.supported_specs()) == 11\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_FAULTS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


TRAINING_MODULES = (
    "repro_torch.tree", "repro_torch.training.optimizer",
    "repro_torch.training.checkpoint", "repro_torch.training.elastic",
    "repro_torch.training.train_loop", "repro_torch.graphs.sampler",
    "repro_torch.data.pipeline", "repro_torch.models.gnn",
    "repro_torch.configs.gat_cora", "repro_torch.configs.gatedgcn",
    "repro_torch.configs.meshgraphnet", "repro_torch.launch.train")


@pytest.fixture(scope="module")
def training_imports():
    """One fresh interpreter per module of the GNN training slice, all
    started at once (each spends seconds importing torch), read by the
    cases below."""
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_FAULTS", None)
    procs = {}
    for first in TRAINING_MODULES:
        code = (f"import {first}\n"
                "import sys\n"
                "from repro_torch import configs\n"
                "from repro_torch.launch import train\n"
                "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
                "('jax', 'jaxlib', 'repro'))\n"
                "assert not bad, bad\n"
                "assert {'gat-cora', 'gatedgcn', 'meshgraphnet'} <= "
                "set(configs.ARCHS)\n"
                "print('ok')\n")
        procs[first] = subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("first", TRAINING_MODULES)
def test_training_module_imports_first(first, training_imports):
    """Each module of the GNN training slice imports first in a fresh
    interpreter, pulls in neither ``jax`` nor the reference package, and
    leaves the GNN archs in the registry."""
    out, err = training_imports[first].communicate(timeout=240)
    assert training_imports[first].returncode == 0, err
    assert out.startswith("ok")


MODELS_MODULES = (
    "repro_torch.models.equivariant", "repro_torch.models.recsys",
    "repro_torch.configs.nequip", "repro_torch.configs.dcn_v2",
    "repro_torch.launch.analysis", "repro_torch.launch.mesh")


@pytest.fixture(scope="module")
def models_imports():
    """One fresh interpreter per module of the nequip / dcn-v2 / roofline
    slice, all started at once, read by the cases below."""
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_FAULTS", None)
    procs = {}
    for first in MODELS_MODULES:
        code = (f"import {first}\n"
                "import sys\n"
                "from repro_torch import configs\n"
                "from repro_torch.launch import analysis, train\n"
                "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
                "('jax', 'jaxlib', 'repro'))\n"
                "assert not bad, bad\n"
                "assert {'nequip', 'dcn-v2'} <= set(configs.ARCHS)\n"
                "assert len(configs.get('nequip').make_full().paths) == 15\n"
                "print('ok')\n")
        procs[first] = subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("first", MODELS_MODULES)
def test_models_module_imports_first(first, models_imports):
    """Each module of the nequip / dcn-v2 / roofline slice imports first in
    a fresh interpreter, with no import cycle, pulling in neither ``jax``
    nor the reference package, and leaves both archs in the registry."""
    out, err = models_imports[first].communicate(timeout=240)
    assert models_imports[first].returncode == 0, err
    assert out.startswith("ok")


MOE_MLA_MODULES = (
    "repro_torch.models.moe", "repro_torch.models.mla",
    "repro_torch.models.scatter",
    "repro_torch.configs.minicpm3_4b", "repro_torch.configs.phi35_moe",
    "repro_torch.configs.qwen2_moe")


@pytest.fixture(scope="module")
def moe_mla_imports():
    """One fresh interpreter per module of the MoE / MLA slice, all started
    at once, read by the cases below."""
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_FAULTS", None)
    procs = {}
    for first in MOE_MLA_MODULES:
        code = (f"import {first}\n"
                "import sys\n"
                "from repro_torch import configs\n"
                "from repro_torch.models import transformer\n"
                "from repro_torch.serving import ServeEngine\n"
                "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
                "('jax', 'jaxlib', 'repro'))\n"
                "assert not bad, bad\n"
                "assert {'minicpm3-4b', 'phi3.5-moe-42b-a6.6b', "
                "'qwen2-moe-a2.7b'} <= set(configs.ARCHS)\n"
                "assert len(configs.ARCHS) == 10\n"
                "assert configs.get('qwen2-moe-a2.7b').make_full().moe.e_pad "
                "== 64\n"
                "print('ok')\n")
        procs[first] = subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("first", MOE_MLA_MODULES)
def test_moe_mla_module_imports_first(first, moe_mla_imports):
    """Each module of the MoE / MLA slice imports first in a fresh
    interpreter, with no import cycle (``moe``, ``gnn``, ``recsys`` and
    ``equivariant`` share ``scatter``, which imports only torch), pulling in neither
    ``jax`` nor the reference package."""
    out, err = moe_mla_imports[first].communicate(timeout=240)
    assert moe_mla_imports[first].returncode == 0, err
    assert out.startswith("ok")


# the reference's package-level names that the port's packages re-export,
# and the modules of the LM training slice
EXPORTS = tuple(("repro_torch.core", n) for n in (
    "ALGORITHMS", "color_rsoc", "color_cat", "color_gm", "color_jp",
    "color_rsoc_compact", "color_distance2", "color_distance_d",
    "color_bipartite_partial", "is_distance_d_proper",
    "is_bipartite_partial_proper")) + (
    ("repro_torch.serving", "ColoringService"),
    ("repro_torch.configs.qwen3_32b", "ARCH"),
    ("repro_torch.models.transformer", "train_step_loss"),
    ("repro_torch.models.layers", "FlashAttention"))


@pytest.fixture(scope="module")
def export_imports():
    """One fresh interpreter per export, importing it first, all started at
    once and read by the cases below."""
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_FAULTS", None)
    procs = {}
    for mod, name in EXPORTS:
        code = (f"from {mod} import {name}\n"
                "import sys\n"
                "from repro_torch import configs, core, serving\n"
                "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
                "('jax', 'jaxlib', 'repro'))\n"
                "assert not bad, bad\n"
                "assert sorted(core.ALGORITHMS) == ['cat', 'gm', 'jp', "
                "'rsoc', 'rsoc_compact']\n"
                "assert serving.ColoringService.__name__ == "
                "'ColoringService'\n"
                "assert {'qwen3-1.7b', 'qwen3-32b'} <= set(configs.ARCHS)\n"
                "print('ok')\n")
        procs[mod, name] = subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("mod,name", EXPORTS,
                         ids=[f"{m}.{n}" for m, n in EXPORTS])
def test_export_imports_first(mod, name, export_imports):
    """Each re-export of ``repro_torch.core`` / ``repro_torch.serving`` (the
    reference's package-level names) and each new name of the LM training
    slice imports first in a fresh interpreter with no import cycle,
    pulling in neither ``jax`` nor the reference package."""
    out, err = export_imports[mod, name].communicate(timeout=240)
    assert export_imports[mod, name].returncode == 0, err
    assert out.startswith("ok")


def test_fresh_interpreter_imports_without_jax_or_reference():
    """Import every module of the port in a new interpreter (with the
    reference package importable, as in this test run) and look at
    ``sys.modules``.  Importing must also build nothing: a machine without
    a CUDA compiler imports every module."""
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'jaxlib' or k == 'repro' or "
        "k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._lib is None and _build.build_seconds is None\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_FAULTS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_refuses_to_run_without_a_gpu_or_the_package(tmp_path):
    """Without a GPU the script exits non-zero and prints no result line;
    alone in a directory (no package beside it) it fails too."""
    import shutil
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal path is not taken")
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != ROOT:
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), script)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, script], env=env, cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


MESH_MODULES = (
    "repro_torch.core.mesh", "repro_torch.launch.mesh",
    "repro_torch.launch.sharding", "repro_torch.launch.cells",
    "repro_torch.models.spmd")


@pytest.fixture(scope="module")
def mesh_imports():
    """One fresh interpreter per module of the model-mesh slice, all
    started at once, read by the cases below."""
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_FAULTS", None)
    procs = {}
    for first in MESH_MODULES:
        code = (f"import {first}\n"
                "import sys\n"
                "from repro_torch.launch import cells, sharding\n"
                "from repro_torch.models import spmd, transformer\n"
                "from repro_torch import api\n"
                "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
                "('jax', 'jaxlib', 'repro'))\n"
                "assert not bad, bad\n"
                "assert sorted(sharding.PARAM_RULES) == ['gnn', 'lm', "
                "'recsys']\n"
                "assert transformer.prefill.__module__ == "
                "'repro_torch.models.transformer'\n"
                "print('ok')\n")
        procs[first] = subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("first", MESH_MODULES)
def test_mesh_module_imports_first(first, mesh_imports):
    """Each module of the model-mesh slice imports first in a fresh
    interpreter, with no import cycle (``spmd`` is reached from
    ``transformer`` at call time), pulling in neither ``jax`` nor the
    reference package."""
    out, err = mesh_imports[first].communicate(timeout=240)
    assert mesh_imports[first].returncode == 0, err
    assert out.startswith("ok")
