from .checkpoint import (
    ModelArtifact,
    artifact_from_trained,
    load_model,
    save_model,
)

__all__ = ["ModelArtifact", "artifact_from_trained", "load_model",
           "save_model"]
