from .collate import fader_collate
from .pipeline import (DataLoader, DevicePrefetcher, PatchQueue, Subset,
                       batched, default_collate)

__all__ = ["DataLoader", "DevicePrefetcher", "PatchQueue", "Subset",
           "batched", "default_collate", "fader_collate"]
