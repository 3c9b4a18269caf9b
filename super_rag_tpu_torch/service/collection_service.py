"""Collection business logic + the built-in search flow (port of the JAX
package's service/collection_service.py).

Counterpart of the reference's CollectionService
(service/collection_service.py): CRUD with quota checks :63-102, and
execute_search_flow :229-366 which builds the search DAG programmatically
(vector_search + optional graph_search -> merge -> rerank) and runs the
nodeflow engine.  Ours adds the fulltext branch as a first-class node and
lets hybrid fusion use RRF.

The graph branch (``use_graph``) adds graph_search -> merge; a reranked
search takes the collection's own reranker (``AppContext.reranker_for``:
its rerank spec's remote provider, the tagged default, or the
cross-encoder).
"""

from __future__ import annotations

from typing import Optional

from super_rag_tpu_torch.api.http import HttpError
from super_rag_tpu_torch.nodeflow.engine import NodeflowEngine
from super_rag_tpu_torch.nodeflow.models import Edge, NodeInstance, NodeflowInstance, SystemInput
import super_rag_tpu_torch.nodeflow.runners  # noqa: F401 — ensure registry
from super_rag_tpu_torch.service.context import AppContext
from super_rag_tpu_torch.store.models import CollectionStatus


class CollectionService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx

    # -- CRUD -------------------------------------------------------------------

    def create(self, user: str, title: str, description: str = "",
               config: Optional[dict] = None) -> dict:
        if not title:
            raise HttpError(422, "title required")
        count = len(self.ctx.db.list_collections(user))
        if count >= self.ctx.cfg.max_collections_per_user:
            raise HttpError(429, "collection quota exceeded")
        coll = self.ctx.db.create_collection(title, user, description,
                                             config or {})
        # initialize the device engine eagerly (reference fires
        # collection_init_task -> SeekDB create_collection; ours is local)
        self.ctx.engines.get(coll["id"], coll["config"])
        self.ctx.db.update_collection(
            coll["id"], status=CollectionStatus.ACTIVE.value
        )
        return self.ctx.db.get_collection(coll["id"])

    def get(self, user: str, cid: str, allow_shared: bool = True) -> dict:
        coll = self.ctx.db.get_collection(cid)
        if coll is None or coll["status"] == CollectionStatus.DELETED.value:
            raise HttpError(404, f"collection {cid} not found")
        if coll["user"] != user:
            if allow_shared and self._is_shared_with(user, cid):
                return coll
            raise HttpError(403, "not your collection")
        return coll

    def _is_shared_with(self, user: str, cid: str) -> bool:
        # direct share grants access (reference api/collections.py:62-120)
        if self.ctx.db.is_shared_with(cid, user):
            return True
        # marketplace: published + subscribed
        mkt = self.ctx.db.query_one(
            "SELECT * FROM marketplace WHERE collection_id=? AND status='PUBLISHED'",
            (cid,),
        )
        return mkt is not None and self.ctx.db.is_subscribed(user, cid)

    def list(self, user: str) -> list[dict]:
        return self.ctx.db.list_collections(user)

    def update(self, user: str, cid: str, **fields) -> dict:
        self.get(user, cid, allow_shared=False)
        allowed = {k: v for k, v in fields.items()
                   if k in ("title", "description", "config") and v is not None}
        if allowed:
            self.ctx.db.update_collection(cid, **allowed)
        return self.ctx.db.get_collection(cid)

    def delete(self, user: str, cid: str) -> None:
        self.get(user, cid, allow_shared=False)
        for doc in self.ctx.db.list_documents(cid):
            self.ctx.db.mark_indexes_deleting(doc["id"])
            self.ctx.db.update_document(doc["id"], status="DELETING")
        self.ctx.reconciler.reconcile_all()
        self.ctx.db.delete_collection(cid)
        # a deleted collection must vanish from the marketplace too
        self.ctx.db.unpublish_collection(cid)
        self.ctx.engines.drop(cid)
        self.ctx.objects.delete_prefix(cid)

    # -- search flow ----------------------------------------------------------------

    def build_search_flow(
        self,
        collection_ids: list[str],
        top_k: int,
        similarity_threshold: Optional[float],
        use_fulltext: bool = True,
        use_graph: bool = False,
        use_rerank: bool = True,
        candidates: int = 100,
    ) -> NodeflowInstance:
        """Programmatic DAG: start -> recall branches -> merge -> rerank
        (reference collection_service.py:264-331)."""
        recall_k = max(top_k, candidates if use_rerank else top_k)
        nodes = [NodeInstance("start", "start")]
        edges = []
        if use_fulltext:
            # ONE fused device program (hybrid_search node) — dense ⊕
            # BM25 ⊕ RRF with no host hops between stages
            recall_node = "hybrid_search"
            nodes.append(
                NodeInstance(
                    "hybrid_search", "hybrid_search",
                    input_values={"top_k": recall_k, "candidates": recall_k,
                                  "collection_ids": collection_ids},
                )
            )
        else:
            recall_node = "vector_search"
            nodes.append(
                NodeInstance(
                    "vector_search", "vector_search",
                    input_values={
                        "top_k": recall_k,
                        "similarity_threshold": similarity_threshold,
                        "collection_ids": collection_ids,
                    },
                )
            )
        edges.append(Edge("start", recall_node, target_handle="query"))

        rerank_source = recall_node
        if use_graph:
            nodes.append(
                NodeInstance(
                    "graph_search", "graph_search",
                    input_values={"top_k": top_k,
                                  "collection_ids": collection_ids},
                )
            )
            edges.append(Edge("start", "graph_search", target_handle="query"))
            nodes.append(
                NodeInstance(
                    "merge", "merge",
                    input_values={
                        "docs": f"{{{{ nodes.{recall_node}.output.docs }}}}",
                        "graph_docs": "{{ nodes.graph_search.output.docs }}",
                    },
                )
            )
            edges.append(Edge(recall_node, "merge", target_handle="docs"))
            edges.append(Edge("graph_search", "merge",
                              target_handle="graph_docs"))
            rerank_source = "merge"
        nodes.append(
            NodeInstance(
                "rerank", "rerank",
                input_values={
                    "docs": f"{{{{ nodes.{rerank_source}.output.docs }}}}",
                    "top_k": top_k,
                },
            )
        )
        edges.append(Edge(rerank_source, "rerank", target_handle="docs"))
        return NodeflowInstance(name="search", nodes=nodes, edges=edges)

    async def execute_multi_search(
        self,
        user: str,
        collection_ids: list[str],
        query: str,
        top_k: Optional[int] = None,
        use_rerank: bool = True,
        chat_id: Optional[str] = None,
    ) -> dict:
        """Search several collections in one flow; the hybrid node fans
        out per collection and merges by score (the reference's
        SearchRequest accepts collection_ids but only searches the first
        — runners/vector_search.py:64; we search them all)."""
        colls = [self.get(user, cid) for cid in collection_ids]
        accessible = [c["id"] for c in colls]
        top_k = top_k or self.ctx.cfg.default_top_k
        flow = self.build_search_flow(
            accessible, top_k, None, use_rerank=use_rerank,
            candidates=self.ctx.cfg.rerank_candidates,
        )
        engine = NodeflowEngine()
        services = self.ctx.services_for_nodeflow()
        if not use_rerank:
            # no cross-encoder: the rerank node keeps the recall order (a
            # kept difference from the reference, ROADMAP C5)
            services["reranker"] = None
        elif colls:
            # rerank spec of the first collection governs (the reference
            # resolves rerank config per search the same way)
            services["reranker"] = self.ctx.reranker_for(
                colls[0].get("config") or {})
        ctx = await engine.execute_nodeflow(
            flow, SystemInput(query=query, user=user, chat_id=chat_id),
            services=services,
        )
        docs = ctx.outputs["rerank"].docs
        return {
            "query": query,
            "collection_ids": accessible,
            "items": [
                {"rank": i + 1, "score": d.score, "text": d.text,
                 "recall_type": d.recall_type, "metadata": d.metadata}
                for i, d in enumerate(docs[:top_k])
            ],
        }

    async def execute_search(
        self,
        user: str,
        collection_id: str,
        query: str,
        top_k: Optional[int] = None,
        similarity_threshold: Optional[float] = None,
        use_fulltext: bool = True,
        use_graph: bool = False,
        use_rerank: bool = True,
        chat_id: Optional[str] = None,
    ) -> dict:
        coll = self.get(user, collection_id)
        top_k = top_k or self.ctx.cfg.default_top_k
        if similarity_threshold is None:
            similarity_threshold = self.ctx.cfg.default_similarity_threshold
        flow = self.build_search_flow(
            [coll["id"]], top_k, similarity_threshold,
            use_fulltext=use_fulltext, use_graph=use_graph,
            use_rerank=use_rerank,
            candidates=self.ctx.cfg.rerank_candidates,
        )
        engine = NodeflowEngine()
        services = self.ctx.services_for_nodeflow()
        if use_rerank:
            services["reranker"] = self.ctx.reranker_for(
                coll.get("config") or {})
        else:
            # no cross-encoder for an unreranked search: the rerank node
            # keeps the hybrid order (the reference still runs its default
            # reranker here: a kept difference, ROADMAP C5)
            services["reranker"] = None
        ctx = await engine.execute_nodeflow(
            flow,
            SystemInput(query=query, user=user, chat_id=chat_id),
            services=services,
        )
        docs = ctx.outputs["rerank"].docs
        items = [
            {
                "rank": i + 1,
                "score": d.score,
                "text": d.text,
                "recall_type": d.recall_type,
                "metadata": d.metadata,
            }
            for i, d in enumerate(docs[:top_k])
        ]
        return {"query": query, "collection_id": collection_id, "items": items}
