"""Host synchronisations a traced step (the profiler's runtime calls that
wait for the card: stream, device and event synchronisations and blocking
copies), inside the step ranges."""


def read(trace, outcome):
    if trace is None or not trace.steps:
        return None
    return trace.host_syncs / trace.steps
