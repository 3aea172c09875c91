"""device_idle_share.replay: share of the traced window with no device operation running, %.
Moves ``flows_per_s``."""

from harness import readers


def read(run):
    return readers.idle_share(run)
