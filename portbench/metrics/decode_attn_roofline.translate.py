"""Least seconds of the cached key and value bytes the decode steps need over decode attention's device seconds, in %."""
from harness import readers


def read(reading):
    return readers.roofline(reading, 'translate', 'decode_attn_s', readers.DECODE_ATTENTION)
