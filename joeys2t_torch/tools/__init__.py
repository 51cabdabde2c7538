"""The port's tools: checkpoint averaging, test fixtures, and measurements run on
a CUDA card."""
