"""K3's device time per (image, threshold, detection) row it scans, in the
80-class training window: K3's device seconds in the traced window over
the program's count of rows launched in it
(``greedy_scan_batched.rows_launched``, read where the trace opens and
where it closes), in ns. None in a program without the count, or where no
row was launched."""

from portbench.metrics import multiclass

LAYER = "Loss, matching"
UNIT = "ns"
SOURCE = "device_trace"
MOVES = "train_dets_per_s"


def read(bench):
    seconds, rows = multiclass.match_seconds(bench), bench.layer.get(
        "match_rows")
    if seconds is None or not rows:
        return None
    return 1e9 * seconds / rows
