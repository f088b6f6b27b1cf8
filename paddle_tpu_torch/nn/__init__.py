from . import functional  # noqa: F401
from .layer import Layer, LayerList  # noqa: F401
from .layers_lib import Dropout, Embedding, LayerNorm, Linear  # noqa: F401
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
