"""Device operations: the hand-written CUDA kernels with their plain
PyTorch versions, and the on-device audio front end."""
