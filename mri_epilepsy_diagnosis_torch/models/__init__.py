from .fader import (AE, Classificator, Decoder, Discriminator, Encoder,
                    make_encoder)
from .unet import UNet3D

__all__ = ["AE", "Classificator", "Decoder", "Discriminator", "Encoder",
           "UNet3D", "make_encoder"]
