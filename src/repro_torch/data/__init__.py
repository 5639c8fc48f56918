"""Input data for the models: the seekable token pipeline for training
and the stubbed modality frontends."""
from .pipeline import (DataConfig, MemmapCorpus, SyntheticTokens,
                       stub_frontend_inputs)

__all__ = ["DataConfig", "MemmapCorpus", "SyntheticTokens",
           "stub_frontend_inputs"]
