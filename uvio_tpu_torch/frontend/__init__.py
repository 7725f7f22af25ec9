from .database import Feature, FeatureDatabase

__all__ = ["Feature", "FeatureDatabase"]
