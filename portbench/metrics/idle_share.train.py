"""Share of the traced slice of updates in which no device operation ran, in %."""
from harness import readers


def read(reading):
    return readers.idle_share(reading, 'train')
