"""Models of the port: the dense Transformer LM and its KV-cache decode."""

from .generate import generate, init_kv_cache
from .transformer import Transformer, TransformerConfig

__all__ = ["Transformer", "TransformerConfig", "generate", "init_kv_cache"]
