"""Input data for the models (the stubbed modality frontends so far)."""
from .pipeline import stub_frontend_inputs

__all__ = ["stub_frontend_inputs"]
