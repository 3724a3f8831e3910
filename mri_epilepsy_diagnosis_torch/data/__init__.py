from .pipeline import DevicePrefetcher

__all__ = ["DevicePrefetcher"]
