"""Share of K2's column blocks with a step that summed d_b' from the row
pass's records, in the dense training cell: the crowd cell's reader
(``pair_bwd_from_records.train_crowd.py``) under the dense cell's name."""

from portbench import run

LAYER = "Kernels (pair stage)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_dets_per_s"


def read(bench):
    return run.reader("pair_bwd_from_records.train_crowd").read(bench)
