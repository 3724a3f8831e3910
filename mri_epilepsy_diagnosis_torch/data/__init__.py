from .collate import fader_collate
from .pipeline import (DataLoader, DevicePrefetcher, PatchQueue, Subset,
                       batched, default_collate, prefetch_to_device)

__all__ = ["DataLoader", "DevicePrefetcher", "PatchQueue", "Subset",
           "batched", "default_collate", "fader_collate",
           "prefetch_to_device"]
