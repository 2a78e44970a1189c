"""Training runtime (port of ``repro.train``): AdamW with the reference's
arithmetic, ``make_train_step``, the synthetic data pipeline and int8
error-feedback gradient compression."""
from .optimizer import (AdamWConfig, adamw_update, clip_by_global_norm,
                        global_norm, init_opt_state, lr_schedule)
from .train_step import make_train_step, value_and_grad
from .compression import (compress_grads, decompress_grads,
                          ef_compressed_psum, init_error_state)
from .data import (DataConfig, bst_batch, lm_batch, recsys_batch,
                   shard_of_batch, to_device, twotower_batch)

__all__ = [
    "AdamWConfig", "adamw_update", "clip_by_global_norm", "global_norm",
    "init_opt_state", "lr_schedule", "make_train_step", "value_and_grad",
    "compress_grads", "decompress_grads", "ef_compressed_psum",
    "init_error_state", "DataConfig", "bst_batch", "lm_batch",
    "recsys_batch", "shard_of_batch", "to_device", "twotower_batch",
]
