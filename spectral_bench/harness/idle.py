"""The device's idle share of a traced window."""


def idle_pct(run):
    """100 * (1 - busy / window), or None without a trace or device
    activity."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    busy = tr.busy_s
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / tr.window_s)
