"""Device operations of the traced updates per update (the host's launch loop)."""
from harness import readers


def read(reading):
    return readers.per_unit(reading, 'train', 'units')
