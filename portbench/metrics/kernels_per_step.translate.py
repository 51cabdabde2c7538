"""Device operations of the traced requests per decode step (the host's decode loop)."""
from harness import readers


def read(reading):
    return readers.per_unit(reading, 'translate', 'decode_steps')
