from .optimizer import optimize

__all__ = ["optimize"]
