"""Models of the port: the dense Transformer LM, its KV-cache decode and
the dense continuous-batching ``DecodeServer``."""

from .generate import generate, init_kv_cache
from .serve import DecodeServer
from .transformer import Transformer, TransformerConfig

__all__ = ["DecodeServer", "Transformer", "TransformerConfig", "generate",
           "init_kv_cache"]
