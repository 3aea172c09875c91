"""The plain reference: what the served spine must produce, worked out
from the benchmark's own inputs with NumPy and plain PyTorch. Nothing here
imports the program under test. ``<family>.py`` holds a model family's
reference, found by the ``family`` of a configuration."""
