"""Import and knob hygiene of the PyTorch port.

An AST walk over ``src/repro_torch``, ``chip_smoke.py`` and the port's
example programs (``examples/*_torch.py``) pins four rules: the port imports neither ``jax`` nor anything of the JAX package
``repro``, nor ``ml_dtypes``; no library kernel (``scaled_dot_product_attention``,
``rms_norm``, ``torch.compile``, ``triton``) stands in for a hand-written
one — ``chip_smoke.py`` may name the first two only inside
``time_library``, which times them as yardsticks; and every
``RJAX_*`` name it mentions is a knob its own copy of ``RuntimeConfig``
declares.  Two subprocess checks cover what an AST cannot: importing the
whole port builds nothing and loads no JAX, and ``chip_smoke.py`` fails
without a result where there is no CUDA card.
"""
import ast
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")
CHIP_SMOKE = os.path.join(ROOT, "chip_smoke.py")
EXAMPLES = os.path.join(ROOT, "examples")


def _port_files():
    out = []
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    examples = [os.path.join(EXAMPLES, f) for f in os.listdir(EXAMPLES)
                if f.endswith("_torch.py")]
    return sorted(out) + [CHIP_SMOKE] + sorted(examples)


def _trees():
    for path in _port_files():
        with open(path) as fh:
            yield path, ast.parse(fh.read(), filename=path)


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_exist():
    names = {os.path.relpath(p, PORT) for p in _port_files()}
    for want in ("core/runtime.py", "kernels/knn_topk.py", "kernels/kmeans_assign.py",
                 "algorithms/knn.py", "algorithms/kmeans.py", "algorithms/linreg.py",
                 "kernels/rmsnorm.py", "kernels/flash_attention.py", "layers/norms.py",
                 "layers/rope.py", "layers/mlp.py", "layers/attention.py", "models/lm.py",
                 "models/convert.py", "configs/__init__.py", "configs/qwen3_0_6b.py",
                 "launch/serve.py", "kernels/rglru_scan.py", "kernels/ssd_scan.py",
                 "layers/rglru.py", "layers/ssd.py", "configs/mamba2_780m.py",
                 "configs/recurrentgemma_9b.py", "optim/adamw.py", "optim/compress.py",
                 "data/pipeline.py", "checkpoint/manager.py", "distributed/steps.py",
                 "launch/train.py", "layers/moe.py", "core/simulator.py",
                 "core/dashboard.py", "core/executors.py", "core/fault.py",
                 "core/futures.py", "core/dag.py", "core/collectives.py",
                 "cluster/__init__.py", "cluster/chaos.py", "cluster/protocol.py",
                 "cluster/peer.py", "cluster/agent.py", "cluster/channel.py",
                 "cluster/eventloop.py", "cluster/cluster.py", "configs/shapes.py",
                 "launch/mesh.py", "distributed/sharding.py", "layers/tp_block.py",
                 "distributed/analysis.py", "launch/dryrun.py"):
        assert want in names
    examples = {os.path.basename(p) for p in _port_files() if p.startswith(EXAMPLES)}
    assert examples == {"quickstart_torch.py", "kmeans_pipeline_torch.py",
                        "serve_lm_torch.py", "train_lm_torch.py"}
    for src in ("knn_topk.cu", "kmeans_assign.cu", "rmsnorm.cu", "flash_attention.cu",
                "rglru_scan.cu", "ssd_scan.cu"):
        assert os.path.exists(os.path.join(PORT, "csrc", src))


def test_no_jax_and_nothing_of_the_jax_package():
    bad = []
    for path, tree in _trees():
        for mod in _imported_modules(tree):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, f"the port imports the reference stack: {bad}"


def test_no_ml_dtypes():
    """The card's machine has no ``ml_dtypes``: bf16 crosses NumPy as
    uint16 bits (``convert.BF16Bits``, the checkpoint manager)."""
    bad = [(os.path.relpath(path, ROOT), mod) for path, tree in _trees()
           for mod in _imported_modules(tree) if mod.split(".")[0] == "ml_dtypes"]
    assert not bad, f"the port imports ml_dtypes: {bad}"


def _yardstick_nodes(tree):
    """The nodes inside ``chip_smoke.py``'s ``time_library`` helper."""
    inside = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "time_library":
            inside.update(id(n) for n in ast.walk(node))
    return inside


def test_no_library_kernel_on_the_kernel_path():
    bad = []
    for path, tree in _trees():
        rel = os.path.relpath(path, ROOT)
        allowed = _yardstick_nodes(tree) if path == CHIP_SMOKE else set()
        for mod in _imported_modules(tree):
            if mod.split(".")[0] == "triton":
                bad.append((rel, mod))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                bad += [(rel, a.name) for a in node.names
                        if a.name in ("scaled_dot_product_attention", "rms_norm")]
            if isinstance(node, ast.Attribute):
                if node.attr in ("scaled_dot_product_attention", "rms_norm") \
                        and id(node) not in allowed:
                    bad.append((rel, node.attr))
                if (node.attr == "compile" and isinstance(node.value, ast.Name)
                        and node.value.id == "torch"):
                    bad.append((rel, "torch.compile"))
    assert not bad, f"library kernels on the port's path: {bad}"


def test_every_rjax_name_is_a_declared_knob():
    from repro_torch.core.config import declared_env_knobs
    declared = set(declared_env_knobs())
    found = set()
    for path in _port_files():
        with open(path) as fh:
            found.update(re.findall(r"RJAX_[A-Z0-9_]+", fh.read()))
    assert found, "the runtime copy should read its RJAX_* knobs"
    assert found <= declared, f"undeclared knob(s): {sorted(found - declared)}"


def test_config_copy_declares_the_same_knobs_as_the_reference():
    from repro.core import config as jconfig
    from repro_torch.core import config
    assert config.declared_env_knobs() == jconfig.declared_env_knobs()
    # one deliberate divergence: the port's worker pools spawn by default
    # (a forked child cannot re-initialise CUDA); every other row is equal
    rows = config.knob_table().splitlines()
    jrows = jconfig.knob_table().splitlines()
    assert len(rows) == len(jrows)
    differ = [(r, j) for r, j in zip(rows, jrows) if r != j]
    assert [r.split(" | ")[0] for r, _ in differ] == ["| `mp_context`"], differ
    (row, jrow), = differ
    assert row.split(" | ")[2] == "spawn" and jrow.split(" | ")[2] == "fork"


def test_importing_the_port_builds_nothing_and_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.core.api\n"
        "import repro_torch.core.simulator, repro_torch.core.dashboard\n"
        "import repro_torch.algorithms, repro_torch.kernels.ops\n"
        "import repro_torch.configs, repro_torch.layers, repro_torch.models\n"
        "import repro_torch.models.convert, repro_torch.launch.serve\n"
        "import repro_torch.launch.train, repro_torch.optim, repro_torch.data\n"
        "import repro_torch.checkpoint, repro_torch.distributed\n"
        "import repro_torch.cluster, repro_torch.cluster.agent\n"
        "import repro_torch.cluster.eventloop, repro_torch.cluster.channel\n"
        "import repro_torch.layers.tp_block, repro_torch.distributed.analysis\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._lib is None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT)


def test_chip_smoke_fails_without_a_result_when_there_is_no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, CHIP_SMOKE], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
