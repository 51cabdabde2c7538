"""PyTorch / CUDA port of joeys2t_tpu for NVIDIA Hopper GPUs.

The JAX package ``joeys2t_tpu`` is the reference; this package keeps its
module names so each counterpart is easy to find, and never imports JAX or
``joeys2t_tpu``. Entry points run on ``cuda`` unless given ``device="cpu"``.
"""
__version__ = "0.1.0"
