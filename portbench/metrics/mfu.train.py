"""Model FLOPs of the traced updates over the slice's seconds and the chips' bf16 peak, in %."""
from harness import readers


def read(reading):
    return readers.mfu(reading, 'train')
