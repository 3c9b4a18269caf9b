from super_rag_tpu_torch.websearch.service import WebSearchService

__all__ = ["WebSearchService"]
