"""Sentences of the requests translated in the window over the window's seconds."""
from harness import readers


def read(reading):
    return readers.rate(reading, 'translate', 'sentences')
