"""Host wall of joeys2t.update over the device seconds of what it launched, in %."""
from harness import spans


def read(reading):
    return spans.host_over_launched(reading, 'train', 'joeys2t.update')
