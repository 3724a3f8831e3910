from .bayes import (BayesConv2d, BayesConv3d, ConvLayer, ConvSample,
                    ConvTransposeLayer, DeFlatten, DownConv, FinalConv,
                    InitConv, UpConv, flatten)
from .brats_unet import BraTSUnet
from .cnn import CNN, LSTM, BasicBlock, ConvLSTM, DilatedCNN, VoxResNet
from .fader import (AE, Classificator, Decoder, Discriminator, Encoder,
                    make_encoder)
from .modified_unet import Modified3DUNet
from .patch_model import ConvolutionBlock, PatchModel
from .residual_unet import ResidualUNet3D
from .unet import UNet3D

__all__ = ["AE", "BasicBlock", "BayesConv2d", "BayesConv3d", "BraTSUnet",
           "CNN", "Classificator", "ConvLSTM", "ConvLayer", "ConvSample",
           "ConvTransposeLayer", "ConvolutionBlock", "DeFlatten", "Decoder",
           "DilatedCNN", "Discriminator", "DownConv", "Encoder", "FinalConv",
           "InitConv", "LSTM", "Modified3DUNet", "PatchModel",
           "ResidualUNet3D", "UNet3D", "UpConv", "VoxResNet", "flatten",
           "make_encoder"]
