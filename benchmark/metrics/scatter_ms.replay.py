"""scatter_ms.replay: device ms per burst of the kernels launched inside the benchmark's
``bench.scatter`` range around ``FlowStateEngine.step`` (``apply_wire``), from
the device trace.
Moves ``flows_per_s``."""

from harness import readers


def read(run):
    return readers.range_device_ms(run, "bench.scatter")
