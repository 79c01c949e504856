"""Share of its bytes roofline that the ``window_gather`` kernel reaches:
each gathered row read once and written once, over 3.35 TB/s, against the
kernel's device time, in percent."""
from bench.peaks import HBM_BYTES_PER_S


def read(rec):
    if rec.trace is None:
        return None
    launches, secs = rec.trace.kernel_time("window_gather")
    if not launches or not secs:
        return None
    cfg = rec.cell.config
    row_bytes = cfg["num_nodes"] * cfg["in_features"] * 4
    span = cfg["input_len"] + cfg["horizon"]
    nbytes = 2 * rec.batch * span * row_bytes * launches
    return 100.0 * nbytes / HBM_BYTES_PER_S / secs
