"""``pipeline_s``: time to result.  The window's elapsed time, from the
first pipeline's start to the last one's end (each ends with its result
on the host, as ``run_*`` returns it), over the pipelines it completed.
Host clock."""


def read(run):
    t0, t1 = run.window
    return (t1 - t0) / len(run.pipelines)
