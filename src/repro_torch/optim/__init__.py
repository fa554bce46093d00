"""The optimizer of the port's training path (``repro_torch.optim``), the
counterpart of ``repro.optim``: AdamW with f32 master weights and
global-norm clipping, the learning-rate schedules, and int8 error-feedback
gradient compression."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .compress import dp_mean_compressed, ef_int8_compress, ef_int8_decompress
from .schedule import Schedule, make_schedule

__all__ = ["AdamWConfig", "Schedule", "adamw_init", "adamw_update", "dp_mean_compressed",
           "ef_int8_compress", "ef_int8_decompress", "global_norm", "make_schedule"]
