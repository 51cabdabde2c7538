"""Least seconds of the flash backward's calls over its kernels' device seconds, in %."""
from harness import readers


def read(reading):
    return readers.roofline(reading, 'train', 'flash_bwd_s', readers.FLASH_BWD)
