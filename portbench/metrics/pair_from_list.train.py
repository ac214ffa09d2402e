"""Share of K1's and K2's row blocks with a step that took their pairs
from the forward's neighbour list, in the dense training cell: the crowd
cell's reader (``pair_from_list.train_crowd.py``) under the dense cell's
name."""

from portbench import run

LAYER = "Kernels (pair stage)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_dets_per_s"


def read(bench):
    return run.reader("pair_from_list.train_crowd").read(bench)
