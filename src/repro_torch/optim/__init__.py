"""repro_torch.optim — AdamW, LR schedules, clipping and int8 gradient
compression over trees of tensors (the reference's ``optim``)."""
from .adamw import AdamWConfig, adamw, apply_updates, init_opt_state
from .clipping import clip_by_global_norm, global_norm
from .compression import compressed_psum, int8_compress, int8_decompress
from .schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["adamw", "AdamWConfig", "init_opt_state", "apply_updates",
           "cosine_schedule", "linear_warmup_cosine", "clip_by_global_norm",
           "global_norm", "int8_compress", "int8_decompress",
           "compressed_psum"]
