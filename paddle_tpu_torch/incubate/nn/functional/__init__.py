from .fused_transformer import (FusedTransformerWeights,
                                contiguous_page_table,
                                fused_multi_transformer,
                                fused_multi_transformer_paged,
                                fused_multi_transformer_paged_ragged,
                                fused_weights_from_llama,
                                paged_cache_from_dense)

__all__ = ["FusedTransformerWeights", "contiguous_page_table",
           "fused_multi_transformer", "fused_multi_transformer_paged",
           "fused_multi_transformer_paged_ragged", "fused_weights_from_llama",
           "paged_cache_from_dense"]
