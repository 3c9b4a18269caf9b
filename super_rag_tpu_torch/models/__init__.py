from super_rag_tpu_torch.models.cross_encoder import CrossEncoder
from super_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder
from super_rag_tpu_torch.models.hash_embedder import HashEmbedder

__all__ = ["EncoderConfig", "TextEncoder", "CrossEncoder", "HashEmbedder"]
