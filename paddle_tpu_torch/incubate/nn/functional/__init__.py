from .fused_transformer import (FusedTransformerWeights,
                                fused_multi_transformer,
                                fused_multi_transformer_paged_ragged,
                                fused_weights_from_llama)

__all__ = ["FusedTransformerWeights", "fused_multi_transformer",
           "fused_multi_transformer_paged_ragged", "fused_weights_from_llama"]
