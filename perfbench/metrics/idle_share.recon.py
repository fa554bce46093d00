"""The device's idle share of the window's part after the trace, in %:
1 - the device time a launch (the traced window's busy time over its
launches) x the launches after the trace / that part's length.  The
profiler slows the host while it traces, and this cell's device waits on
the host once a pass, so the traced window's own idle share reads the
profiler."""


def read(run):
    traced, n = run.counters.get("traced_launches"), run.counters.get("untraced_launches")
    seconds = run.counters.get("untraced_s")
    if not traced or not n or not seconds or not run.events:
        return None
    return 100.0 * (1.0 - run.busy_s() / traced * n / seconds)
