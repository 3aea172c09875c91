"""step_mfu.replay: the traced window's model operations (KNN: rows x corpus x (2F + 1);
forest: node visits + rows x trees x classes) over the window at the
H100's float32 peak, %.
Moves ``flows_per_s``."""

from harness import readers


def read(run):
    return readers.step_mfu(run)
