"""The PyTorch port's example programs (``examples/*_torch.py``), each run
as a subprocess on the CPU (``--device cpu``) at a tiny size: each must
exit 0 and print its result.  Without ``--device cpu`` they run on the
CUDA card and fail where there is none."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _run(name, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, os.path.join(ROOT, "examples", name), *args],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)


@pytest.mark.parametrize("name,args,want", [
    ("quickstart_torch.py", [], "The result is: 22"),
    ("kmeans_pipeline_torch.py", ["--points", "6000", "--iters", "3"],
     "projected makespan on  64 workers"),
    ("kmeans_pipeline_torch.py", ["--points", "6000", "--iters", "3", "--backend", "process"],
     "projected makespan on  64 workers"),
    ("quickstart_torch.py", ["--backend", "process"], "The result is: 22"),
    ("quickstart_torch.py", ["--backend", "cluster"], "The result is: 22"),
    ("kmeans_pipeline_torch.py", ["--points", "6000", "--iters", "3", "--backend", "cluster"],
     "projected makespan on  64 workers"),
    ("serve_lm_torch.py", ["--arch", "deepseek-moe-16b", "--requests", "2", "--prompt-len", "8",
                           "--gen-len", "3"], "generated token matrix (2, 3)"),
    ("serve_lm_torch.py", ["--arch", "qwen3-0.6b", "--requests", "2", "--prompt-len", "8",
                           "--gen-len", "3"], "generated token matrix (2, 3)"),
    ("train_lm_torch.py", ["--steps", "3", "--batch", "2", "--seq", "16"], "loss "),
    ("train_lm_torch.py", ["--arch", "deepseek-moe-16b", "--steps", "2", "--batch", "2",
                           "--seq", "16"], "aux "),
], ids=["quickstart", "kmeans_pipeline", "kmeans_pipeline_process", "quickstart_process",
        "quickstart_cluster", "kmeans_pipeline_cluster", "serve_moe", "serve_dense", "train", "train_moe"])
def test_example_runs_on_the_cpu(name, args, want):
    proc = _run(name, *args, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert want in proc.stdout


def test_examples_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run("quickstart_torch.py")
    assert proc.returncode != 0 and "CUDA" in proc.stderr
