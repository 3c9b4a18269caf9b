"""API contract models of the serving seam (port of the JAX package's
schema/view_models.py, the models that the ported routes parse).

Routes parse inbound payloads through these, so an invalid body fails
with a 422 whose text is the first error's location and message, word
for word as the JAX package's pydantic models give it.
"""

from __future__ import annotations

from typing import Any, Literal, Optional

from super_rag_tpu_torch.schema.model import Field, Model, ValidationError, field_validator

# -- model / collection configuration -----------------------------------------


class ModelSpec(Model):
    """Which provider/model serves an api for a collection."""

    provider: str = ""
    model: str = ""
    dim: Optional[int] = None  # embeddings only; None = probe/default


class KGEntityType(Model):
    """One custom knowledge-graph entity type."""

    name: str = Field(min_length=1, max_length=64)
    description: str = Field(default="", max_length=300)
    pattern: Optional[str] = Field(default=None, max_length=300)


class CollectionConfig(Model):
    """Per-collection JSON config (stored in collection.config)."""

    metric: Literal["cosine", "ip", "l2"] = "cosine"
    index_dtype: Literal["float32", "bfloat16", "int8"] = "bfloat16"
    bm25_slots: int = Field(default=64, ge=8, le=512)
    vocab_size: int = Field(default=1 << 17, ge=1 << 10)
    enable_summary: bool = False
    enable_vision: bool = False
    enable_knowledge_graph: bool = False
    kg_entity_types: list[KGEntityType] = Field(default_factory=list)
    embedding: Optional[ModelSpec] = None
    completion: Optional[ModelSpec] = None
    rerank: Optional[ModelSpec] = None

    @field_validator("vocab_size")
    @classmethod
    def _pow2(cls, v: int) -> int:
        if v & (v - 1) != 0:
            raise ValueError("vocab_size must be a power of two")
        return v


class CollectionCreate(Model):
    title: str = Field(min_length=1, max_length=256)
    description: str = ""
    config: CollectionConfig = Field(default_factory=CollectionConfig)


class CollectionUpdate(Model):
    title: Optional[str] = Field(default=None, min_length=1, max_length=256)
    description: Optional[str] = None
    config: Optional[CollectionConfig] = None


# -- documents -----------------------------------------------------------------


class DocumentUpload(Model):
    name: str = Field(min_length=1, max_length=512)
    content: Optional[str] = None
    content_base64: Optional[str] = None
    metadata: dict = Field(default_factory=dict)
    chat_id: Optional[str] = None


# -- search ---------------------------------------------------------------------


class SearchRequest(Model):
    """POST /collections/{id}/searches body."""

    query: str = Field(min_length=1)
    top_k: int = Field(default=5, ge=1, le=100)
    similarity_threshold: Optional[float] = Field(default=0.2, ge=-1.0, le=1.0)
    use_fulltext: bool = True
    use_graph: bool = False
    use_rerank: bool = True
    chat_id: Optional[str] = None


class MultiSearchRequest(Model):
    query: str = Field(min_length=1)
    collection_ids: list[str] = Field(min_length=1)
    top_k: int = Field(default=5, ge=1, le=100)
    use_rerank: bool = True
    chat_id: Optional[str] = None


class ImageSearchRequest(Model):
    image_base64: str = Field(min_length=4)
    top_k: int = Field(default=5, ge=1, le=100)


# -- workflows --------------------------------------------------------------------


class WorkflowNode(Model):
    id: str = Field(min_length=1)
    type: str = Field(min_length=1)
    data: dict = Field(default_factory=dict)


class WorkflowEdge(Model):
    source: str
    target: str
    sourceHandle: Optional[str] = None
    targetHandle: Optional[str] = None


class WorkflowGraph(Model):
    nodes: list[WorkflowNode]
    edges: list[WorkflowEdge] = Field(default_factory=list)


class WorkflowDefinition(Model):
    name: str = ""
    graph: WorkflowGraph
    input_schema: dict = Field(default_factory=dict)


class WorkflowCreate(Model):
    title: str = Field(min_length=1, max_length=256)
    definition: WorkflowDefinition


class WorkflowRunRequest(Model):
    inputs: dict = Field(default_factory=dict)


# -- chats / agents -----------------------------------------------------------------


class ChatCreate(Model):
    title: str = Field(default="", max_length=256)
    collection_ids: list[str] = Field(default_factory=list)


class AgentCreate(Model):
    title: str = Field(min_length=1, max_length=256)
    description: str = ""
    config: dict = Field(default_factory=dict)


class AgentUpdate(Model):
    title: Optional[str] = Field(default=None, min_length=1, max_length=256)
    description: Optional[str] = None
    config: Optional[dict] = None


# -- llm providers ---------------------------------------------------------------


class LLMProviderCreate(Model):
    name: str = Field(min_length=1, max_length=128)
    label: str = ""
    base_url: str = ""
    api_type: str = "openai"


class LLMProviderModelCreate(Model):
    api: Literal["completion", "embedding", "rerank"] = "completion"
    model: str = Field(min_length=1, max_length=256)
    context_window: int = Field(default=0, ge=0)
    max_tokens: int = Field(default=0, ge=0)
    tags: list[str] = Field(default_factory=list)


class ProviderKeySet(Model):
    api_key: str = Field(min_length=1)


# -- auth ---------------------------------------------------------------------------


class RegisterRequest(Model):
    username: str = Field(min_length=1, max_length=64)
    password: str = Field(min_length=8, max_length=256)
    email: str = ""


class LoginRequest(Model):
    username: str
    password: str


class ChangePasswordRequest(Model):
    username: str = ""
    old_password: str
    new_password: str = Field(min_length=8, max_length=256)


class ApiKeyCreate(Model):
    description: str = ""


# -- web search -----------------------------------------------------------------------


class WebSearchRequest(Model):
    # query may be empty when ``source`` drives llms.txt discovery
    query: str = Field(default="")
    max_results: int = Field(default=5, ge=1, le=50)
    source: Optional[str] = None
    providers: Optional[list] = None


def parse_body(model: type[Model], data: Any):
    """Validate a request body against a contract model; raises the
    router's 422 with the first error's location and message."""
    from super_rag_tpu_torch.api.http import HttpError

    try:
        return model(**(data or {}))
    except ValidationError as e:
        first = e.errors()[0]
        loc = ".".join(str(x) for x in first["loc"])
        raise HttpError(422, f"{loc}: {first['msg']}") from e
