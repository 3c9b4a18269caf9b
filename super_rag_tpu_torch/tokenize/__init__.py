from super_rag_tpu_torch.tokenize.analyzer import Analyzer, DocFrequency, fnv1a32

__all__ = ["Analyzer", "DocFrequency", "fnv1a32"]
