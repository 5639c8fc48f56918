"""The model zoo in PyTorch, every family of the reference: configuration,
parameter table, layers, blocks, the serving model, and numpy carry-across.

The reference's pure ``prefill`` and ``decode_step`` are the methods of
:class:`Model` here; its ``loss_fn`` is :func:`models.train.loss_fn`.
"""
from .config import (EncoderConfig, ModelConfig, MoEConfig, RGLRUConfig,
                     SSMConfig, Stage, VisionConfig, expand_stages,
                     find_stages, torch_dtype)
from .model import (Model, abstract_cache, cache_logical_specs, cache_table,
                    init_cache)
from .params import (abstract_params, count_params, init_params,
                     logical_specs, param_table)
from .train import loss_fn

__all__ = ["EncoderConfig", "ModelConfig", "MoEConfig", "RGLRUConfig",
           "SSMConfig", "Stage", "VisionConfig", "expand_stages",
           "find_stages", "torch_dtype", "Model", "abstract_cache",
           "cache_logical_specs", "cache_table", "init_cache",
           "abstract_params", "count_params", "init_params",
           "logical_specs", "param_table", "loss_fn"]
