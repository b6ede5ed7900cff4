"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
CUDA card: ``python3 bench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``, from the root of a checkout.  See
``bench/harness/runner.py``."""
import time

T_START = time.perf_counter()   # set-up is timed from here

if __name__ == "__main__":
    import pathlib
    import sys

    # the checkout's root, in place of this directory, on the path
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])
    from bench.harness.runner import main

    sys.exit(main(t_start=T_START))
