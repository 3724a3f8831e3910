from .intensity import znormalization

__all__ = ["znormalization"]
