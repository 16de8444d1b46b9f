"""Problem/model library."""

from .quantum import DrivenDense

__all__ = ["DrivenDense"]
