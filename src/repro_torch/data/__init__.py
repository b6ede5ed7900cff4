"""The port's data pipeline (``repro/data``): synthetic batches prefetched
as runtime tasks."""
from .pipeline import DataPipeline, synth_batch  # noqa: F401
