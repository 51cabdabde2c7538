"""Utilities (counterpart of joeys2t_tpu.utils)."""
