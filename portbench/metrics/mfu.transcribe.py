"""Model FLOPs of the traced requests (encoder and decode steps) over the slice's seconds and the chips' bf16 peak, in %."""
from harness import readers


def read(reading):
    return readers.mfu(reading, 'transcribe')
