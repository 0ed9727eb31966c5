from .convert import load_paddle_tpu_state
from .generation import lm_head_tail
from .kv_cache import KVCacheSpec, check_request_fits
from .llama import LLAMA_PRESETS, LlamaConfig, LlamaForCausalLM
from .mamba import MambaConfig, MambaForCausalLM
from .mamba2 import Mamba2Config, Mamba2ForCausalLM
from .moe_llm import MoELlamaConfig, MoELlamaForCausalLM
from .rwkv import RwkvConfig, RwkvForCausalLM

__all__ = ["LLAMA_PRESETS", "LlamaConfig", "LlamaForCausalLM",
           "KVCacheSpec", "check_request_fits", "lm_head_tail",
           "load_paddle_tpu_state", "MoELlamaConfig", "MoELlamaForCausalLM",
           "MambaConfig", "MambaForCausalLM", "Mamba2Config",
           "Mamba2ForCausalLM", "RwkvConfig", "RwkvForCausalLM"]
