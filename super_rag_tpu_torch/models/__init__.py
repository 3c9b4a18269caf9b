_EXPORTS = {
    "CrossEncoder": "super_rag_tpu_torch.models.cross_encoder",
    "EncoderConfig": "super_rag_tpu_torch.models.encoder",
    "TextEncoder": "super_rag_tpu_torch.models.encoder",
    "HashEmbedder": "super_rag_tpu_torch.models.hash_embedder",
}


def __getattr__(name: str):
    # resolved on first use, so a process that only decodes images
    # (models/image_embedder.py embed_image) imports no torch
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["EncoderConfig", "TextEncoder", "CrossEncoder", "HashEmbedder"]
