from .cc import label_components

__all__ = ["label_components"]
