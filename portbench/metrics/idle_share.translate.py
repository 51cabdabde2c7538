"""Share of the traced requests' slice in which no device operation ran, in %."""
from harness import readers


def read(reading):
    return readers.idle_share(reading, 'translate')
