"""The program's own spans, for the per-layer readers of `benchmark/metrics/`.

The port records spans and host syncs while a `torch.profiler` session
records (`equiadapt_tpu_torch.utils.profiling`); on a `--trace 1` run that
session is the window's profiled head. A reader takes one figure of one
span from the newest recorded session's summary, as an operator would read
it. A program without the recorder, or a session without the span, gives
None: the reader then reports nothing, and raises nothing.
"""


def span_figure(record, mode: str, span: str, figure: str):
    """`figure` ("host_ms", "device_ms" or "syncs", a call's mean) of
    `span` in the program's newest recorded session, or None unless the
    record's mode is `mode` and the run was traced."""
    if record.get("mode") != mode or not record.get("trace"):
        return None
    try:
        from equiadapt_tpu_torch.utils import profiling

        session = profiling.last_session()
    except (ImportError, AttributeError):
        return None
    if session is None:
        return None
    row = session.summary().get(span)
    if not row or row.get(figure) is None:
        return None
    return float(row[figure])
