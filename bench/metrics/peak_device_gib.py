"""``peak_device_gib``: the card memory the pipelines need, in GiB: the
peak of ``torch.cuda.max_memory_reserved()`` of the harness process over
set-up and the window.  Every pipeline runs in a runtime of its own,
which is stopped and collected before the next starts, so the peak is
what one pipeline holds at once (its data, every task result the runtime
keeps, the caching allocator's slack), and it bounds the data set a user
can run.  Thread backend: under ``"process"`` the workers' memory is
their own and not in it."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30
