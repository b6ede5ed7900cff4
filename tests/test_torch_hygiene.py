"""Import and knob hygiene of the PyTorch port.

An AST walk over ``src/repro_torch`` and ``chip_smoke.py`` pins three
rules: the port imports neither ``jax`` nor anything of the JAX package
``repro``; no library kernel (``scaled_dot_product_attention``,
``torch.compile``, ``triton``) stands in for a hand-written one; and every
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


def _port_files():
    out = []
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    return sorted(out) + [CHIP_SMOKE]


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
                 "algorithms/knn.py", "algorithms/kmeans.py", "algorithms/linreg.py"):
        assert want in names


def test_no_jax_and_nothing_of_the_jax_package():
    bad = []
    for path, tree in _trees():
        for mod in _imported_modules(tree):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, f"the port imports the reference stack: {bad}"


def test_no_library_kernel_on_the_kernel_path():
    bad = []
    for path, tree in _trees():
        rel = os.path.relpath(path, ROOT)
        for mod in _imported_modules(tree):
            if mod.split(".")[0] == "triton":
                bad.append((rel, mod))
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                if node.attr == "scaled_dot_product_attention":
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
    assert config.knob_table() == jconfig.knob_table()


def test_importing_the_port_builds_nothing_and_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.core.api\n"
        "import repro_torch.algorithms, repro_torch.kernels.ops\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._lib is None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
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
