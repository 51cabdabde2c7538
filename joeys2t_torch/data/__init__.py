"""Data-side operations (counterpart of joeys2t_tpu.data)."""
