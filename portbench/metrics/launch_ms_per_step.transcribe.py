"""Host ms a greedy decode step spends outside its read-back (the program's joeys2t.decode.step less joeys2t.decode.readback)."""
from harness import spans


def read(reading):
    return spans.launch_ms_per_step(reading, 'transcribe')
