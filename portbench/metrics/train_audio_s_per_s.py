"""Audio seconds of the updates completed in the window over the window's seconds."""
from harness import readers


def read(reading):
    return readers.rate(reading, 'train', 'audio_s')
