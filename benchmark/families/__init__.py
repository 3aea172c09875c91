"""The program's side of each model family: ``<family>.build(config,
seed, device, root)`` returns the port's loaded model, and ``KERNEL`` names
the family's kernel in the device trace. A family may also give a
``Recorder`` of what its kernel returned on the timed path."""
