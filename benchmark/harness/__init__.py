"""The benchmark's harness: the generator, the code that runs the spine,
the comparison with the reference, the yardstick and the trace reading."""
