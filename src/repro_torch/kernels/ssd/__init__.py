from . import ops, ref

__all__ = ["ops", "ref"]
