"""Device seconds launched in the beam's selection (joeys2t.beam.select) over those launched in joeys2t.decode, in %."""
from harness import spans


def read(reading):
    return spans.launched_share(reading, 'translate', ('joeys2t.beam.select',), 'joeys2t.decode')
