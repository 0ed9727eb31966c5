from .convert import load_paddle_tpu_optimizer_state, load_paddle_tpu_state
from .generation import (GenerationMixin, fused_generate, generate,
                         lm_head_tail, sample_logits)
from .kv_cache import KVCacheSpec, check_request_fits
from .llama import (LLAMA_PRESETS, KVCache, LlamaConfig, LlamaForCausalLM,
                    LlamaModel)
from .mamba import MambaConfig, MambaForCausalLM, selective_scan
from .mamba2 import Mamba2Config, Mamba2ForCausalLM
from .moe_llm import MoELlamaConfig, MoELlamaForCausalLM
from .rwkv import RwkvConfig, RwkvForCausalLM
from .serving import ServingDecoder
from .unet import (UNET_PRESETS, UNet2DConditionModel, UNetConfig,
                   timestep_embedding)
from .vit import VIT_PRESETS, ViTConfig, VisionTransformer

__all__ = ["LLAMA_PRESETS", "LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "KVCache", "selective_scan",
           "KVCacheSpec", "check_request_fits", "lm_head_tail",
           "sample_logits", "generate", "fused_generate", "GenerationMixin",
           "ServingDecoder", "load_paddle_tpu_state",
           "load_paddle_tpu_optimizer_state", "MoELlamaConfig",
           "MoELlamaForCausalLM", "MambaConfig", "MambaForCausalLM",
           "Mamba2Config", "Mamba2ForCausalLM", "RwkvConfig",
           "RwkvForCausalLM", "ViTConfig", "VisionTransformer",
           "VIT_PRESETS", "UNetConfig", "UNet2DConditionModel",
           "UNET_PRESETS", "timestep_embedding"]
