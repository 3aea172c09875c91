"""device_stage_ms.replay: ``ServePipeline.stats()["device_busy_s"]`` per render: the device-stage
worker's wall time per render, waits on the card included.
Moves ``flows_per_s``."""

from harness import readers


def read(run):
    return readers.device_stage_ms(run)
