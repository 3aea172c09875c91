"""ingest_ms.replay: host ms per burst of ``FlowStateEngine.ingest_bytes`` (the native C++ parse and flow-state
update), from the benchmark's span around the call.
Moves ``flows_per_s``."""

from harness import readers


def read(run):
    return readers.mean_span_ms(run, "ingest")
