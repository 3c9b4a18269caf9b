from super_rag_tpu_torch.engine.collection import CollectionEngine
from super_rag_tpu_torch.engine.index import DeviceIndex, FilterSpec, IndexSpec

__all__ = ["DeviceIndex", "IndexSpec", "FilterSpec", "CollectionEngine"]
