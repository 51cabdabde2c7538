"""Device seconds launched in the beam's scoring (joeys2t.beam.scores) over those launched in joeys2t.decode, in %."""
from harness import spans


def read(reading):
    return spans.launched_share(reading, 'translate', ('joeys2t.beam.scores',), 'joeys2t.decode')
