from .cnn import CNN, LSTM, BasicBlock, ConvLSTM, DilatedCNN, VoxResNet
from .fader import (AE, Classificator, Decoder, Discriminator, Encoder,
                    make_encoder)
from .patch_model import ConvolutionBlock, PatchModel
from .unet import UNet3D

__all__ = ["AE", "BasicBlock", "CNN", "Classificator", "ConvLSTM",
           "ConvolutionBlock", "Decoder", "DilatedCNN", "Discriminator",
           "Encoder", "LSTM", "PatchModel", "UNet3D", "VoxResNet",
           "make_encoder"]
