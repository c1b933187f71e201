"""`search_issue_ms` (ms): the mean host time from the call of
`ChunkStore.search_device` to its return, before the answers are read: the
plan table, the launches and the host work between them. Read from the
benchmark's own span around each call, over the calls the profiler did
not record."""


def read(ctx) -> float | None:
    calls, _ = ctx.window.steady()
    calls = [c for c in calls if c.units]
    if not calls:
        return None
    return 1e3 * sum(c.issue_s for c in calls) / len(calls)
