"""Audio seconds of the requests transcribed in the window over the window's seconds."""
from harness import readers


def read(reading):
    return readers.rate(reading, 'transcribe', 'audio_s')
