"""predict_rows.replay: mean ``IncrementalLabels.status()["dirty_rows"]`` per render: the rows
the label cache sends to the kernel.
Moves ``flows_per_s``."""

from harness import readers


def read(run):
    return readers.predict_rows(run)
