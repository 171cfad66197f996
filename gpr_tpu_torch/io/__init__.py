from .checkpoint import ModelArtifact, load_model, save_model

__all__ = ["ModelArtifact", "load_model", "save_model"]
