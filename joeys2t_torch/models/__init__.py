"""Model modules (counterpart of joeys2t_tpu.models)."""
from joeys2t_torch.models.model import ModelSpec, Seq2SeqModel, build_model
