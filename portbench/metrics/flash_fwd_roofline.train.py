"""Least seconds of the flash forward's calls over its kernels' device seconds, in %."""
from harness import readers


def read(reading):
    return readers.roofline(reading, 'train', 'flash_fwd_s', readers.FLASH_FWD)
