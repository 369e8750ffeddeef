"""``device_idle_pct`` (%): the share of the traced window in which no
kernel, copy or memset runs on the card (``torch.profiler``)."""


def read(run):
    device = run.traced.device
    if device is None or device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - device["busy_s"] / device["window_s"])
