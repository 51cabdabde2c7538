"""Device seconds launched in joeys2t.optimizer (reduce, clip, AdamW, zero_grad) over those launched in joeys2t.update, in %."""
from harness import spans


def read(reading):
    return spans.launched_share(reading, 'train', ('joeys2t.optimizer',), 'joeys2t.update')
