from .kv import MetaStore

__all__ = ["MetaStore"]
