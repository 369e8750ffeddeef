"""``p50_ms`` (ms): the median (nearest rank) of the latencies of every
request sent in the window, from when it was due to the hits returned; a
failed request, or one that never answered, counts as infinitely late."""

import math


def read(run):
    lat = sorted(run.counts.latencies_ms.tolist())
    return lat[max(0, math.ceil(0.5 * len(lat)) - 1)] if lat else None
