from .unet import UNet3D

__all__ = ["UNet3D"]
