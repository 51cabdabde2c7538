"""Plain PyTorch reference of the benchmark's models and the comparisons
that decide ``correct``; it imports nothing of the program."""
