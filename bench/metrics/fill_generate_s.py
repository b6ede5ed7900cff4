"""``fill_generate_s``: host seconds a pipeline's fill tasks spend
generating their data (NumPy blobs and the cast to float32): the fill
bodies' ``generate`` spans, summed over the workers, per pipeline."""
from bench.harness.spans import fill_span_s


def read(run):
    return fill_span_s(run, "generate")
