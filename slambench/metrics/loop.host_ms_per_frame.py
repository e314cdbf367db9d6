"""loop.host_ms_per_frame (ms): the harness's host span around each
`process_frame_async` call of the window (dispatch, retirement, the
diagnostics' staging and any wait in them), summed, over the calls."""


def read(run):
    spans = run.window.spans
    return 1e3 * sum(spans) / len(spans) if spans else None
