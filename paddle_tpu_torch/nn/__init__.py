from . import functional  # noqa: F401
from .layer import Layer, LayerList, Sequential  # noqa: F401
from .layers_lib import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm,  # noqa: F401
                         BatchNorm1D, BatchNorm2D, BatchNorm3D, Conv2D,
                         Dropout, Embedding, Flatten, LayerNorm, Linear,
                         MaxPool2D, ReLU, ReLU6, Softmax)
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
