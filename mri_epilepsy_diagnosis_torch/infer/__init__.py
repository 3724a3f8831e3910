from .serving import segment_volumes

__all__ = ["segment_volumes"]
