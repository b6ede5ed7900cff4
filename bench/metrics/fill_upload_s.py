"""``fill_upload_s``: host seconds a pipeline's fill tasks spend moving
their data to the card (the synchronous ``.to(device)`` of a pageable
host tensor): the fill bodies' ``upload`` spans, summed over the
workers, per pipeline."""
from bench.harness.spans import fill_span_s


def read(run):
    return fill_span_s(run, "upload")
