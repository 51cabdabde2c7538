"""Device seconds launched in joeys2t.frontend and joeys2t.encode over those launched in joeys2t.request, in %."""
from harness import spans


def read(reading):
    return spans.launched_share(reading, 'transcribe', ('joeys2t.frontend', 'joeys2t.encode'),
                                'joeys2t.request')
