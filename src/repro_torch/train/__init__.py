"""Training: AdamW and its schedules, the train and eval steps, and int8
gradient compression with error feedback."""
from .compress import (compress_with_feedback, compressed_grad_allreduce,
                       dequantize, init_error_state, quantize)
from .optimizer import (OptConfig, adamw_update, global_norm,
                        init_opt_state, schedule_lr)
from .step import make_eval_step, make_train_step

__all__ = ["OptConfig", "adamw_update", "global_norm", "init_opt_state",
           "schedule_lr", "make_eval_step", "make_train_step",
           "compress_with_feedback", "compressed_grad_allreduce",
           "dequantize", "init_error_state", "quantize"]
