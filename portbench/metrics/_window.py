"""What the per-layer readers share: the spans of the traced window."""


def inside(run, spans):
    """The ``(start, end, ...)`` spans that lie wholly in the traced window
    (host clock)."""
    lo, hi = run.traced.host_start, run.traced.host_stop
    return [s for s in spans if lo <= s[0] and s[1] <= hi]


def mean_ms(spans):
    return 1e3 * sum(s[1] - s[0] for s in spans) / len(spans) if spans else None
