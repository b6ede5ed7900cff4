"""Quickstart on the PyTorch port — the twin of ``examples/quickstart.py``:
the paper's Fig. 2 program on ``repro_torch``'s task runtime.

Four numbers, here tensors on the device, are summed through three
asynchronous ``add`` tasks; the runtime discovers the dependency DAG
(main -> {1,2} -> 3 -> sync) and prints it in Graphviz form, like
``runcompss --lang=r -g job.R``.  The port's runtime has the thread
backend only: task bodies run in this process, so their results stay on
the card from task to task.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(the default device is the CUDA card)
"""
import argparse

import torch

from repro_torch.algorithms.common import resolve_device
from repro_torch.core import api


def add(x, y):
    return x + y


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args().device)
    api.runtime_start(n_workers=4)           # compss_start()
    try:
        add_t = api.task(add)                # task(add, ...)
        a, b, c, d = (torch.tensor(float(v), device=dev) for v in (4, 5, 6, 7))
        res1 = add_t(a, b)                   # Task (1)
        res2 = add_t(c, d)                   # Task (2)
        res3 = add_t(res1, res2)             # Task (3) — depends on 1 & 2
        res3 = api.wait_on(res3)             # compss_wait_on(res3)
        print(f"The result is: {float(res3):g} (on {res3.device})")
        print("\nTask DAG (the -g flag's output):")
        print(api.current_runtime().graph.to_dot())
    finally:
        api.runtime_stop()                   # compss_stop()
    assert float(res3) == 22.0


if __name__ == "__main__":
    main()
