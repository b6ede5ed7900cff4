"""The benchmark harness of the PyTorch and CUDA port (``repro_torch``):
cells, configurations, pipeline kinds, references and metric readers are
files found by the names in ``BENCHMARK.json``."""
