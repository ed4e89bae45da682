from .loader import EvalLoader

__all__ = ["EvalLoader"]
