"""The port's native (C++) host-runtime components. See engine.py."""
