"""The model zoo in PyTorch, every family of the reference: configuration,
parameter table, layers, blocks, the serving model, and numpy carry-across.
"""
from .config import ModelConfig, Stage, find_stages, torch_dtype
from .model import Model, cache_logical_specs, cache_table, init_cache
from .params import count_params, init_params

__all__ = ["ModelConfig", "Stage", "find_stages", "torch_dtype", "Model",
           "cache_logical_specs", "cache_table", "init_cache",
           "count_params", "init_params"]
