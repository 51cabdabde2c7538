"""Share of the greedy decode loop's wall (the program's joeys2t.decode) with no device operation, in %."""
from harness import spans


def read(reading):
    return spans.loop_idle_share(reading, 'transcribe')
