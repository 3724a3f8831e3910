from .cnn import CNN, LSTM, BasicBlock, ConvLSTM, DilatedCNN, VoxResNet
from .fader import (AE, Classificator, Decoder, Discriminator, Encoder,
                    make_encoder)
from .unet import UNet3D

__all__ = ["AE", "BasicBlock", "CNN", "Classificator", "ConvLSTM",
           "Decoder", "DilatedCNN", "Discriminator", "Encoder", "LSTM",
           "UNet3D", "VoxResNet", "make_encoder"]
