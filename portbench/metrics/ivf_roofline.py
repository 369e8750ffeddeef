"""``ivf_roofline`` (%): the least time kernel 7 needs for the unfiltered
IVF scans of the traced window, summed over the program's ``ivf.scan``
spans that lie wholly in it (each scan's bytes and operations from its
attributes through the configuration's ``portbench/work/`` file, against
``portbench/peaks.py``), over the device time of kernel 7's scan kernels
in the window (every kernel whose name holds ``ivf_topk_kernel``, from
``torch.profiler``).  A scan's kernels run inside its span, so the scans
counted are no more than the kernels timed.  None where the program
records no such span."""

from portbench import manifest, peaks
from portbench.metrics._program import in_window

K7_KERNELS = "ivf_topk_kernel"


def read(run):
    device = run.traced.device if run.traced is not None else None
    scans = [s[6] for s in in_window(run, "ivf.scan") if not s[6].get("masked", True)]
    if device is None or not scans:
        return None
    kernel_s = sum(seconds for name, seconds in device["ops"] if K7_KERNELS in name)
    if kernel_s <= 0:
        return None
    work = manifest.work(run.cfg["work"]).work
    least = sum(
        peaks.least_seconds(**work(a["queries"], a["k"], int(run.cfg["rows"]), a["dim"], list_rows=a["list_rows"],
                                   pair_rows=a["pair_rows"], lists=a["lists"], lrows=a["lrows"]))
        for a in scans
    )
    return 100.0 * least / kernel_s
