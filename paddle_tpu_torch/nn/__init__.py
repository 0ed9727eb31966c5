from . import clip, conv, functional, loss, transformer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grads_)
from .conv import Conv2D
from .functional import GroupNorm, LayerNorm, RMSNorm
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, HingeEmbeddingLoss, KLDivLoss, L1Loss,
                   MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                   TripletMarginLoss)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["clip", "conv", "functional", "loss", "transformer", "Conv2D",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grads_", "GroupNorm", "LayerNorm", "RMSNorm",
           "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss", "CosineEmbeddingLoss", "HingeEmbeddingLoss",
           "TripletMarginLoss", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]
