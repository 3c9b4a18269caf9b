"""Relational metadata store on sqlite3 (stdlib; port of the JAX package's
store/db.py with the same tables, columns and SQL, so a database file
written by either package opens in the other).

Plays the role of the reference's SQLAlchemy/MySQL layer (db/models.py +
db/ops.py repository mixins) for collections, documents, index specs,
users/api-keys, chats, workflows, providers, audit log, and marketplace.
sqlite3 in WAL mode behind one lock is plenty for a metadata plane whose
hot path lives on the device; the schema keeps the reference's reconciler
contract (version / observed_version / status CAS updates).
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
import uuid
from typing import Any, Iterable, Optional

from super_rag_tpu_torch.store.models import (
    CollectionStatus,
    DocumentStatus,
    IndexStatus,
)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS collection (
  id TEXT PRIMARY KEY, title TEXT NOT NULL, description TEXT DEFAULT '',
  user TEXT NOT NULL, status TEXT NOT NULL, config TEXT DEFAULT '{}',
  created REAL NOT NULL, updated REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS document (
  id TEXT PRIMARY KEY, collection_id TEXT NOT NULL, name TEXT NOT NULL,
  status TEXT NOT NULL, size INTEGER DEFAULT 0, content_hash TEXT DEFAULT '',
  object_path TEXT DEFAULT '', metadata TEXT DEFAULT '{}',
  chat_id TEXT DEFAULT NULL,
  created REAL NOT NULL, updated REAL NOT NULL,
  FOREIGN KEY (collection_id) REFERENCES collection(id)
);
CREATE INDEX IF NOT EXISTS idx_document_coll ON document(collection_id);
CREATE TABLE IF NOT EXISTS document_index (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  document_id TEXT NOT NULL, index_type TEXT NOT NULL,
  status TEXT NOT NULL, version INTEGER NOT NULL DEFAULT 1,
  observed_version INTEGER NOT NULL DEFAULT 0,
  index_data TEXT DEFAULT '{}', error_message TEXT DEFAULT '',
  created REAL NOT NULL, updated REAL NOT NULL,
  UNIQUE(document_id, index_type)
);
CREATE TABLE IF NOT EXISTS user (
  id TEXT PRIMARY KEY, username TEXT UNIQUE NOT NULL,
  email TEXT DEFAULT '', password_hash TEXT NOT NULL,
  role TEXT DEFAULT 'user', is_active INTEGER DEFAULT 1, created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS oauth_account (
  id TEXT PRIMARY KEY, user_id TEXT NOT NULL, provider TEXT NOT NULL,
  account_id TEXT NOT NULL, account_email TEXT DEFAULT '',
  access_token TEXT DEFAULT '', created REAL NOT NULL,
  UNIQUE(provider, account_id)
);
CREATE TABLE IF NOT EXISTS api_key (
  id TEXT PRIMARY KEY, user TEXT NOT NULL, key TEXT UNIQUE NOT NULL,
  description TEXT DEFAULT '', created REAL NOT NULL,
  last_used REAL DEFAULT NULL
);
CREATE TABLE IF NOT EXISTS chat (
  id TEXT PRIMARY KEY, user TEXT NOT NULL, title TEXT DEFAULT '',
  bot_id TEXT DEFAULT '', peer_type TEXT DEFAULT 'bot', status TEXT DEFAULT 'ACTIVE',
  created REAL NOT NULL, updated REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS chat_message (
  id TEXT PRIMARY KEY, chat_id TEXT NOT NULL, role TEXT NOT NULL,
  parts TEXT NOT NULL DEFAULT '[]', trace_id TEXT DEFAULT '',
  feedback TEXT DEFAULT NULL, created REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_msg_chat ON chat_message(chat_id);
CREATE TABLE IF NOT EXISTS workflow (
  id TEXT PRIMARY KEY, user TEXT NOT NULL, title TEXT DEFAULT '',
  description TEXT DEFAULT '', created REAL NOT NULL, updated REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS workflow_version (
  id INTEGER PRIMARY KEY AUTOINCREMENT, workflow_id TEXT NOT NULL,
  version INTEGER NOT NULL, definition TEXT NOT NULL, created REAL NOT NULL,
  UNIQUE(workflow_id, version)
);
CREATE TABLE IF NOT EXISTS workflow_run (
  id TEXT PRIMARY KEY, workflow_id TEXT DEFAULT '', version INTEGER DEFAULT 1,
  user TEXT DEFAULT '', status TEXT NOT NULL, inputs TEXT DEFAULT '{}',
  outputs TEXT DEFAULT '{}', error TEXT DEFAULT '',
  started REAL DEFAULT NULL, finished REAL DEFAULT NULL, created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS node_run (
  id INTEGER PRIMARY KEY AUTOINCREMENT, run_id TEXT NOT NULL,
  node_id TEXT NOT NULL, node_type TEXT DEFAULT '', status TEXT NOT NULL,
  inputs TEXT DEFAULT '{}', outputs TEXT DEFAULT '{}', error TEXT DEFAULT '',
  duration_ms REAL DEFAULT 0, created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS llm_provider (
  name TEXT PRIMARY KEY, label TEXT DEFAULT '', base_url TEXT DEFAULT '',
  api_type TEXT DEFAULT 'openai', allow_custom_base_url INTEGER DEFAULT 0,
  extra TEXT DEFAULT '{}', user TEXT DEFAULT 'public', created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS llm_model (
  id INTEGER PRIMARY KEY AUTOINCREMENT, provider TEXT NOT NULL,
  api TEXT NOT NULL, model TEXT NOT NULL, custom_provider TEXT DEFAULT '',
  context_window INTEGER DEFAULT 0, max_tokens INTEGER DEFAULT 0,
  tags TEXT DEFAULT '[]', created REAL NOT NULL,
  UNIQUE(provider, api, model)
);
CREATE TABLE IF NOT EXISTS provider_key (
  id INTEGER PRIMARY KEY AUTOINCREMENT, provider TEXT NOT NULL,
  user TEXT NOT NULL, api_key TEXT NOT NULL, created REAL NOT NULL,
  UNIQUE(provider, user)
);
CREATE TABLE IF NOT EXISTS audit_log (
  id INTEGER PRIMARY KEY AUTOINCREMENT, user TEXT DEFAULT '',
  path TEXT NOT NULL, method TEXT NOT NULL, status_code INTEGER DEFAULT 0,
  latency_ms REAL DEFAULT 0, request TEXT DEFAULT '', response TEXT DEFAULT '',
  resource_type TEXT DEFAULT '', resource_id TEXT DEFAULT '',
  created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS agent (
  id TEXT PRIMARY KEY, user TEXT NOT NULL, title TEXT NOT NULL,
  description TEXT DEFAULT '', config TEXT DEFAULT '{}',
  created REAL NOT NULL, updated REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS collection_share (
  id TEXT PRIMARY KEY, collection_id TEXT NOT NULL, user TEXT NOT NULL,
  granted_by TEXT NOT NULL, created REAL NOT NULL,
  UNIQUE(collection_id, user)
);
CREATE TABLE IF NOT EXISTS marketplace (
  id TEXT PRIMARY KEY, collection_id TEXT UNIQUE NOT NULL,
  status TEXT DEFAULT 'PUBLISHED', published_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS subscription (
  id TEXT PRIMARY KEY, user TEXT NOT NULL, collection_id TEXT NOT NULL,
  created REAL NOT NULL, UNIQUE(user, collection_id)
);
CREATE TABLE IF NOT EXISTS prompt_template (
  id TEXT PRIMARY KEY, user TEXT NOT NULL, name TEXT NOT NULL,
  prompt TEXT NOT NULL, description TEXT DEFAULT '',
  language TEXT DEFAULT 'en-US', created REAL NOT NULL, updated REAL,
  UNIQUE(user, name, language)
);
"""


def _now() -> float:
    return time.time()


def new_id(prefix: str = "") -> str:
    return (prefix + "-" if prefix else "") + uuid.uuid4().hex[:20]


class Database:
    """Thread-safe sqlite3 wrapper with domain operations."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(
            path, check_same_thread=False, isolation_level=None
        )
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        with self._lock:
            if path != ":memory:":
                self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA foreign_keys=ON")
            self._conn.executescript(_SCHEMA)
        from super_rag_tpu_torch.store.migrations import run_migrations

        run_migrations(self)

    # -- low level -----------------------------------------------------------

    def execute(self, sql: str, params: Iterable[Any] = ()) -> sqlite3.Cursor:
        with self._lock:
            return self._conn.execute(sql, tuple(params))

    def query(self, sql: str, params: Iterable[Any] = ()) -> list[dict]:
        with self._lock:
            rows = self._conn.execute(sql, tuple(params)).fetchall()
        return [dict(r) for r in rows]

    def query_one(self, sql: str, params: Iterable[Any] = ()) -> Optional[dict]:
        rows = self.query(sql + " LIMIT 1", params)
        return rows[0] if rows else None

    def transaction(self):
        return _Txn(self)

    # -- collections -----------------------------------------------------------

    def create_collection(
        self, title: str, user: str, description: str = "", config: dict | None = None
    ) -> dict:
        cid = new_id("col")
        t = _now()
        self.execute(
            "INSERT INTO collection (id,title,description,user,status,config,created,updated)"
            " VALUES (?,?,?,?,?,?,?,?)",
            (cid, title, description, user,
             CollectionStatus.INACTIVE.value, json.dumps(config or {}), t, t),
        )
        return self.get_collection(cid)

    def get_collection(self, cid: str) -> Optional[dict]:
        row = self.query_one("SELECT * FROM collection WHERE id=?", (cid,))
        if row:
            row["config"] = json.loads(row["config"])
        return row

    def list_collections(self, user: Optional[str] = None,
                         include_deleted: bool = False) -> list[dict]:
        sql = "SELECT * FROM collection WHERE 1=1"
        params: list = []
        if user is not None:
            sql += " AND user=?"
            params.append(user)
        if not include_deleted:
            sql += " AND status != 'DELETED'"
        rows = self.query(sql + " ORDER BY created DESC", params)
        for r in rows:
            r["config"] = json.loads(r["config"])
        return rows

    def update_collection(self, cid: str, **fields) -> None:
        if "config" in fields and not isinstance(fields["config"], str):
            fields["config"] = json.dumps(fields["config"])
        fields["updated"] = _now()
        sets = ", ".join(f"{k}=?" for k in fields)
        self.execute(
            f"UPDATE collection SET {sets} WHERE id=?", (*fields.values(), cid)
        )

    def delete_collection(self, cid: str) -> None:
        self.update_collection(cid, status=CollectionStatus.DELETED.value)

    # -- documents --------------------------------------------------------------

    def create_document(
        self, collection_id: str, name: str, size: int = 0,
        content_hash: str = "", object_path: str = "",
        metadata: dict | None = None, chat_id: Optional[str] = None,
    ) -> dict:
        did = new_id("doc")
        t = _now()
        self.execute(
            "INSERT INTO document (id,collection_id,name,status,size,content_hash,"
            "object_path,metadata,chat_id,created,updated) VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            (did, collection_id, name, DocumentStatus.PENDING.value, size,
             content_hash, object_path, json.dumps(metadata or {}), chat_id, t, t),
        )
        return self.get_document(did)

    def get_document(self, did: str) -> Optional[dict]:
        row = self.query_one("SELECT * FROM document WHERE id=?", (did,))
        if row:
            row["metadata"] = json.loads(row["metadata"])
        return row

    def list_documents(self, collection_id: str,
                       include_deleted: bool = False) -> list[dict]:
        sql = "SELECT * FROM document WHERE collection_id=?"
        if not include_deleted:
            sql += " AND status != 'DELETED'"
        rows = self.query(sql + " ORDER BY created DESC", (collection_id,))
        for r in rows:
            r["metadata"] = json.loads(r["metadata"])
        return rows

    def find_document_by_hash(self, collection_id: str, content_hash: str) -> Optional[dict]:
        return self.query_one(
            "SELECT * FROM document WHERE collection_id=? AND content_hash=?"
            " AND status != 'DELETED'",
            (collection_id, content_hash),
        )

    def update_document(self, did: str, **fields) -> None:
        if "metadata" in fields and not isinstance(fields["metadata"], str):
            fields["metadata"] = json.dumps(fields["metadata"])
        fields["updated"] = _now()
        sets = ", ".join(f"{k}=?" for k in fields)
        self.execute(f"UPDATE document SET {sets} WHERE id=?", (*fields.values(), did))

    # -- document indexes (reconciler contract) -----------------------------------

    def upsert_document_index(self, document_id: str, index_type: str) -> dict:
        """Create spec row (PENDING v1) or bump version for re-index
        (reference index/manager.py:24-61)."""
        t = _now()
        existing = self.query_one(
            "SELECT * FROM document_index WHERE document_id=? AND index_type=?",
            (document_id, index_type),
        )
        if existing is None:
            self.execute(
                "INSERT INTO document_index (document_id,index_type,status,version,"
                "observed_version,created,updated) VALUES (?,?,?,1,0,?,?)",
                (document_id, index_type, IndexStatus.PENDING.value, t, t),
            )
        else:
            self.execute(
                "UPDATE document_index SET version=version+1, status=?, updated=?"
                " WHERE id=?",
                (IndexStatus.PENDING.value, t, existing["id"]),
            )
        return self.query_one(
            "SELECT * FROM document_index WHERE document_id=? AND index_type=?",
            (document_id, index_type),
        )

    def mark_indexes_deleting(self, document_id: str) -> None:
        self.execute(
            "UPDATE document_index SET status=?, updated=? WHERE document_id=?"
            " AND status != 'DELETED'",
            (IndexStatus.DELETING.value, _now(), document_id),
        )

    def get_document_indexes(self, document_id: str) -> list[dict]:
        return self.query(
            "SELECT * FROM document_index WHERE document_id=?", (document_id,)
        )

    def indexes_needing_reconciliation(self) -> list[dict]:
        """PENDING with observed < version -> create/update; DELETING -> delete
        (reference tasks/reconciler.py:61-75)."""
        return self.query(
            "SELECT * FROM document_index WHERE"
            " (status=? AND observed_version < version) OR status=?",
            (IndexStatus.PENDING.value, IndexStatus.DELETING.value),
        )

    def claim_index(self, index_id: int, from_status: str, to_status: str,
                    version: int) -> bool:
        """Atomic CAS claim (reference tasks/reconciler.py:109-183)."""
        cur = self.execute(
            "UPDATE document_index SET status=?, updated=? WHERE id=? AND status=?"
            " AND version=?",
            (to_status, _now(), index_id, from_status, version),
        )
        return cur.rowcount == 1

    def complete_index(self, index_id: int, version: int, index_data: dict) -> bool:
        """CREATING ∧ version unchanged -> ACTIVE, observed=version."""
        cur = self.execute(
            "UPDATE document_index SET status=?, observed_version=?, index_data=?,"
            " error_message='', updated=? WHERE id=? AND status=? AND version=?",
            (IndexStatus.ACTIVE.value, version, json.dumps(index_data), _now(),
             index_id, IndexStatus.CREATING.value, version),
        )
        return cur.rowcount == 1

    def fail_index(self, index_id: int, version: int, error: str) -> bool:
        cur = self.execute(
            "UPDATE document_index SET status=?, error_message=?, updated=?"
            " WHERE id=? AND version=? AND status IN (?,?)",
            (IndexStatus.FAILED.value, error[:2000], _now(), index_id, version,
             IndexStatus.CREATING.value, IndexStatus.PENDING.value),
        )
        return cur.rowcount == 1

    def delete_index_done(self, index_id: int) -> bool:
        cur = self.execute(
            "UPDATE document_index SET status=?, updated=? WHERE id=? AND status=?",
            (IndexStatus.DELETED.value, _now(), index_id,
             IndexStatus.DELETION_IN_PROGRESS.value),
        )
        return cur.rowcount == 1

    def rebuild_indexes(self, document_id: str, only_failed: bool = False) -> int:
        """Re-drive by bumping version back to PENDING (reference
        api/collections.py:226-247)."""
        sql = (
            "UPDATE document_index SET version=version+1, status=?, updated=?"
            " WHERE document_id=? AND status NOT IN ('DELETED','DELETING')"
        )
        params = [IndexStatus.PENDING.value, _now(), document_id]
        if only_failed:
            sql += " AND status=?"
            params.append(IndexStatus.FAILED.value)
        return self.execute(sql, params).rowcount

    # -- users / api keys ----------------------------------------------------------

    def create_user(self, username: str, password_hash: str, email: str = "",
                    role: str = "user") -> dict:
        uid = new_id("usr")
        self.execute(
            "INSERT INTO user (id,username,email,password_hash,role,created)"
            " VALUES (?,?,?,?,?,?)",
            (uid, username, email, password_hash, role, _now()),
        )
        return self.query_one("SELECT * FROM user WHERE id=?", (uid,))

    def get_user(self, username: str) -> Optional[dict]:
        return self.query_one("SELECT * FROM user WHERE username=?", (username,))

    # -- oauth accounts (reference db/models.py:108-143) -----------------------

    def get_oauth_account(self, provider: str, account_id: str) -> Optional[dict]:
        return self.query_one(
            "SELECT * FROM oauth_account WHERE provider=? AND account_id=?",
            (provider, account_id),
        )

    def add_oauth_account(self, user_id: str, provider: str, account_id: str,
                          email: str = "", access_token: str = "") -> dict:
        oid = new_id("oau")
        self.execute(
            "INSERT INTO oauth_account (id,user_id,provider,account_id,"
            "account_email,access_token,created) VALUES (?,?,?,?,?,?,?)",
            (oid, user_id, provider, account_id, email, access_token, _now()),
        )
        return self.query_one("SELECT * FROM oauth_account WHERE id=?", (oid,))

    def update_oauth_token(self, provider: str, account_id: str,
                           access_token: str) -> None:
        self.execute(
            "UPDATE oauth_account SET access_token=? WHERE provider=? AND"
            " account_id=?",
            (access_token, provider, account_id),
        )

    def list_oauth_accounts(self, user_id: str) -> list[dict]:
        return self.query(
            "SELECT provider, account_id, account_email, created FROM"
            " oauth_account WHERE user_id=?",
            (user_id,),
        )

    def get_user_by_id(self, uid: str) -> Optional[dict]:
        return self.query_one("SELECT * FROM user WHERE id=?", (uid,))

    def list_users(self) -> list[dict]:
        return self.query("SELECT * FROM user ORDER BY created")

    def set_user_password(self, username: str, password_hash: str) -> None:
        self.execute("UPDATE user SET password_hash=? WHERE username=?",
                     (password_hash, username))

    def delete_user(self, uid: str) -> bool:
        """Deactivate, don't drop: ownership everywhere is keyed by the
        username string, so freeing the name for re-registration would
        hand the new account all of the old user's collections/chats.
        The row stays as a tombstone (register 409s on the name); auth
        paths all reject is_active=0."""
        row = self.get_user_by_id(uid)
        if row is None or not row["is_active"]:
            return False
        self.execute("DELETE FROM api_key WHERE user=?", (uid,))
        self.execute("DELETE FROM oauth_account WHERE user_id=?", (uid,))
        self.execute("UPDATE user SET is_active=0 WHERE id=?", (uid,))
        return True

    def create_api_key(self, user: str, description: str = "") -> dict:
        kid = new_id("key")
        key = "sk-" + uuid.uuid4().hex
        self.execute(
            "INSERT INTO api_key (id,user,key,description,created) VALUES (?,?,?,?,?)",
            (kid, user, key, description, _now()),
        )
        return self.query_one("SELECT * FROM api_key WHERE id=?", (kid,))

    def get_api_key(self, key: str) -> Optional[dict]:
        return self.query_one("SELECT * FROM api_key WHERE key=?", (key,))

    def list_api_keys(self, user: str) -> list[dict]:
        return self.query("SELECT * FROM api_key WHERE user=?", (user,))

    def delete_api_key(self, kid: str, user: str) -> bool:
        return self.execute(
            "DELETE FROM api_key WHERE id=? AND user=?", (kid, user)
        ).rowcount == 1

    # -- chats -----------------------------------------------------------------------

    def create_chat(self, user: str, title: str = "", bot_id: str = "") -> dict:
        cid = new_id("chat")
        t = _now()
        self.execute(
            "INSERT INTO chat (id,user,title,bot_id,created,updated)"
            " VALUES (?,?,?,?,?,?)",
            (cid, user, title, bot_id, t, t),
        )
        return self.query_one("SELECT * FROM chat WHERE id=?", (cid,))

    def get_chat(self, cid: str) -> Optional[dict]:
        return self.query_one("SELECT * FROM chat WHERE id=?", (cid,))

    def list_chats(self, user: str) -> list[dict]:
        return self.query(
            "SELECT * FROM chat WHERE user=? AND status='ACTIVE' ORDER BY updated DESC",
            (user,),
        )

    def update_chat(self, cid: str, **fields) -> None:
        fields["updated"] = _now()
        sets = ", ".join(f"{k}=?" for k in fields)
        self.execute(f"UPDATE chat SET {sets} WHERE id=?", (*fields.values(), cid))

    def add_chat_message(self, chat_id: str, role: str, parts: list,
                         trace_id: str = "") -> dict:
        mid = new_id("msg")
        self.execute(
            "INSERT INTO chat_message (id,chat_id,role,parts,trace_id,created)"
            " VALUES (?,?,?,?,?,?)",
            (mid, chat_id, role, json.dumps(parts), trace_id, _now()),
        )
        return self.get_chat_message(mid)

    def get_chat_message(self, mid: str) -> Optional[dict]:
        row = self.query_one("SELECT * FROM chat_message WHERE id=?", (mid,))
        if row:
            row["parts"] = json.loads(row["parts"])
        return row

    def list_chat_messages(self, chat_id: str, limit: int = 100) -> list[dict]:
        rows = self.query(
            "SELECT * FROM chat_message WHERE chat_id=? ORDER BY created LIMIT ?",
            (chat_id, limit),
        )
        for r in rows:
            r["parts"] = json.loads(r["parts"])
        return rows

    def set_message_feedback(self, mid: str, feedback: Optional[str]) -> None:
        self.execute(
            "UPDATE chat_message SET feedback=? WHERE id=?", (feedback, mid)
        )

    # -- workflows ---------------------------------------------------------------------

    def create_workflow(self, user: str, title: str, definition: dict,
                        description: str = "") -> dict:
        wid = new_id("wf")
        t = _now()
        self.execute(
            "INSERT INTO workflow (id,user,title,description,created,updated)"
            " VALUES (?,?,?,?,?,?)",
            (wid, user, title, description, t, t),
        )
        self.execute(
            "INSERT INTO workflow_version (workflow_id,version,definition,created)"
            " VALUES (?,1,?,?)",
            (wid, json.dumps(definition), t),
        )
        return self.get_workflow(wid)

    def get_workflow(self, wid: str) -> Optional[dict]:
        row = self.query_one("SELECT * FROM workflow WHERE id=?", (wid,))
        if not row:
            return None
        ver = self.query_one(
            "SELECT * FROM workflow_version WHERE workflow_id=?"
            " ORDER BY version DESC",
            (wid,),
        )
        row["version"] = ver["version"] if ver else 0
        row["definition"] = json.loads(ver["definition"]) if ver else {}
        return row

    def list_workflows(self, user: str) -> list[dict]:
        return self.query(
            "SELECT * FROM workflow WHERE user=? ORDER BY updated DESC", (user,)
        )

    def add_workflow_version(self, wid: str, definition: dict) -> int:
        ver = self.query_one(
            "SELECT MAX(version) AS v FROM workflow_version WHERE workflow_id=?",
            (wid,),
        )
        nv = (ver["v"] or 0) + 1
        self.execute(
            "INSERT INTO workflow_version (workflow_id,version,definition,created)"
            " VALUES (?,?,?,?)",
            (wid, nv, json.dumps(definition), _now()),
        )
        self.execute("UPDATE workflow SET updated=? WHERE id=?", (_now(), wid))
        return nv

    def get_workflow_version(self, wid: str, version: int) -> Optional[dict]:
        row = self.query_one(
            "SELECT * FROM workflow_version WHERE workflow_id=? AND version=?",
            (wid, version),
        )
        if row:
            row["definition"] = json.loads(row["definition"])
        return row

    def delete_workflow(self, wid: str) -> None:
        self.execute(
            "DELETE FROM node_run WHERE run_id IN"
            " (SELECT id FROM workflow_run WHERE workflow_id=?)", (wid,))
        self.execute("DELETE FROM workflow_run WHERE workflow_id=?", (wid,))
        self.execute("DELETE FROM workflow_version WHERE workflow_id=?", (wid,))
        self.execute("DELETE FROM workflow WHERE id=?", (wid,))

    def list_workflow_versions(self, wid: str) -> list[dict]:
        rows = self.query(
            "SELECT * FROM workflow_version WHERE workflow_id=? ORDER BY version",
            (wid,),
        )
        for r in rows:
            r["definition"] = json.loads(r["definition"])
        return rows

    def create_workflow_run(self, workflow_id: str, user: str, inputs: dict,
                            version: int = 1) -> dict:
        rid = new_id("run")
        self.execute(
            "INSERT INTO workflow_run (id,workflow_id,version,user,status,inputs,"
            "started,created) VALUES (?,?,?,?,?,?,?,?)",
            (rid, workflow_id, version, user, "RUNNING", json.dumps(inputs),
             _now(), _now()),
        )
        return self.get_workflow_run(rid)

    def get_workflow_run(self, rid: str) -> Optional[dict]:
        row = self.query_one("SELECT * FROM workflow_run WHERE id=?", (rid,))
        if row:
            row["inputs"] = json.loads(row["inputs"])
            row["outputs"] = json.loads(row["outputs"])
        return row

    def finish_workflow_run(self, rid: str, status: str, outputs: dict,
                            error: str = "") -> None:
        self.execute(
            "UPDATE workflow_run SET status=?, outputs=?, error=?, finished=?"
            " WHERE id=?",
            (status, json.dumps(outputs), error, _now(), rid),
        )

    def list_workflow_runs(self, workflow_id: str) -> list[dict]:
        rows = self.query(
            "SELECT * FROM workflow_run WHERE workflow_id=? ORDER BY created DESC",
            (workflow_id,),
        )
        for r in rows:
            r["inputs"] = json.loads(r["inputs"])
            r["outputs"] = json.loads(r["outputs"])
        return rows

    def add_node_run(self, run_id: str, node_id: str, node_type: str,
                     status: str, inputs: dict, outputs: dict,
                     error: str = "", duration_ms: float = 0) -> None:
        self.execute(
            "INSERT INTO node_run (run_id,node_id,node_type,status,inputs,outputs,"
            "error,duration_ms,created) VALUES (?,?,?,?,?,?,?,?,?)",
            (run_id, node_id, node_type, status, json.dumps(inputs),
             json.dumps(outputs), error, duration_ms, _now()),
        )

    def list_node_runs(self, run_id: str) -> list[dict]:
        rows = self.query(
            "SELECT * FROM node_run WHERE run_id=? ORDER BY id", (run_id,)
        )
        for r in rows:
            r["inputs"] = json.loads(r["inputs"])
            r["outputs"] = json.loads(r["outputs"])
        return rows

    # -- llm providers --------------------------------------------------------------------

    def upsert_provider(self, name: str, label: str = "", base_url: str = "",
                        api_type: str = "openai", user: str = "public") -> None:
        self.execute(
            "INSERT INTO llm_provider (name,label,base_url,api_type,user,created)"
            " VALUES (?,?,?,?,?,?) ON CONFLICT(name) DO UPDATE SET label=excluded.label,"
            " base_url=excluded.base_url, api_type=excluded.api_type",
            (name, label, base_url, api_type, user, _now()),
        )

    def update_provider(self, name: str, **fields) -> Optional[dict]:
        """Partial update; dialect fields live in the extra JSON column
        (reference LlmProviderUpdateWithApiKey, api/llm.py:92-104)."""
        row = self.get_provider(name)
        if row is None:
            return None
        cols = {}
        extra = json.loads(row.get("extra") or "{}")
        for k, v in fields.items():
            if v is None:
                continue
            if k in ("label", "base_url", "api_type"):
                cols[k] = v
            elif k == "allow_custom_base_url":
                cols[k] = int(bool(v))
            else:
                extra[k] = v
        cols["extra"] = json.dumps(extra)
        sets = ", ".join(f"{k}=?" for k in cols)
        self.execute(f"UPDATE llm_provider SET {sets} WHERE name=?",
                     (*cols.values(), name))
        return self.get_provider(name)

    def list_providers(self) -> list[dict]:
        return self.query("SELECT * FROM llm_provider ORDER BY name")

    def get_provider(self, name: str) -> Optional[dict]:
        return self.query_one("SELECT * FROM llm_provider WHERE name=?", (name,))

    def delete_provider(self, name: str) -> None:
        self.execute("DELETE FROM llm_provider WHERE name=?", (name,))
        self.execute("DELETE FROM llm_model WHERE provider=?", (name,))

    def upsert_model(self, provider: str, api: str, model: str,
                     context_window: int = 0, max_tokens: int = 0,
                     tags: list | None = None) -> None:
        self.execute(
            "INSERT INTO llm_model (provider,api,model,context_window,max_tokens,"
            "tags,created) VALUES (?,?,?,?,?,?,?) ON CONFLICT(provider,api,model)"
            " DO UPDATE SET context_window=excluded.context_window,"
            " max_tokens=excluded.max_tokens, tags=excluded.tags",
            (provider, api, model, context_window, max_tokens,
             json.dumps(tags or []), _now()),
        )

    def list_models(self, provider: Optional[str] = None,
                    api: Optional[str] = None, tag: Optional[str] = None) -> list[dict]:
        sql = "SELECT * FROM llm_model WHERE 1=1"
        params: list = []
        if provider:
            sql += " AND provider=?"
            params.append(provider)
        if api:
            sql += " AND api=?"
            params.append(api)
        rows = self.query(sql + " ORDER BY provider, model", params)
        for r in rows:
            r["tags"] = json.loads(r["tags"])
        if tag:
            rows = [r for r in rows if tag in r["tags"]]
        return rows

    def delete_model(self, provider: str, api: str, model: str) -> None:
        self.execute(
            "DELETE FROM llm_model WHERE provider=? AND api=? AND model=?",
            (provider, api, model),
        )

    def set_provider_key(self, provider: str, user: str, api_key: str) -> None:
        self.execute(
            "INSERT INTO provider_key (provider,user,api_key,created) VALUES (?,?,?,?)"
            " ON CONFLICT(provider,user) DO UPDATE SET api_key=excluded.api_key",
            (provider, user, api_key, _now()),
        )

    def get_provider_key(self, provider: str, user: str) -> Optional[str]:
        row = self.query_one(
            "SELECT api_key FROM provider_key WHERE provider=? AND user=?",
            (provider, user),
        )
        return row["api_key"] if row else None

    # -- prompt templates (reference prompt_template_service CRUD) -------------------------

    def create_prompt_template(self, user: str, name: str, prompt: str,
                               description: str = "",
                               language: str = "en-US") -> dict:
        pid = new_id("ptp")
        self.execute(
            "INSERT INTO prompt_template"
            " (id,user,name,prompt,description,language,created,updated)"
            " VALUES (?,?,?,?,?,?,?,?)",
            (pid, user, name, prompt, description, language, _now(), _now()),
        )
        return self.get_prompt_template(pid)

    def get_prompt_template(self, pid: str) -> Optional[dict]:
        return self.query_one(
            "SELECT * FROM prompt_template WHERE id=?", (pid,)
        )

    def list_prompt_templates(self, user: str,
                              language: Optional[str] = None) -> list[dict]:
        if language:
            return self.query(
                "SELECT * FROM prompt_template WHERE user=? AND language=?"
                " ORDER BY name", (user, language),
            )
        return self.query(
            "SELECT * FROM prompt_template WHERE user=? ORDER BY name",
            (user,),
        )

    def update_prompt_template(self, pid: str, **fields) -> None:
        allowed = {k: v for k, v in fields.items()
                   if k in ("name", "prompt", "description", "language")}
        if not allowed:
            return
        sets = ", ".join(f"{k}=?" for k in allowed)
        self.execute(
            f"UPDATE prompt_template SET {sets}, updated=? WHERE id=?",
            (*allowed.values(), _now(), pid),
        )

    def delete_prompt_template(self, pid: str) -> None:
        self.execute("DELETE FROM prompt_template WHERE id=?", (pid,))

    # -- agents (bots) ---------------------------------------------------------------------

    def create_agent(self, user: str, title: str, description: str = "",
                     config: dict | None = None) -> dict:
        aid = new_id("agt")
        t = _now()
        self.execute(
            "INSERT INTO agent (id,user,title,description,config,created,updated)"
            " VALUES (?,?,?,?,?,?,?)",
            (aid, user, title, description, json.dumps(config or {}), t, t),
        )
        return self.get_agent(aid)

    def get_agent(self, aid: str) -> Optional[dict]:
        row = self.query_one("SELECT * FROM agent WHERE id=?", (aid,))
        if row:
            row["config"] = json.loads(row["config"])
        return row

    def list_agents(self, user: str) -> list[dict]:
        rows = self.query(
            "SELECT * FROM agent WHERE user=? ORDER BY updated DESC", (user,)
        )
        for r in rows:
            r["config"] = json.loads(r["config"])
        return rows

    def update_agent(self, aid: str, **fields) -> None:
        if "config" in fields and not isinstance(fields["config"], str):
            fields["config"] = json.dumps(fields["config"])
        fields["updated"] = _now()
        sets = ", ".join(f"{k}=?" for k in fields)
        self.execute(f"UPDATE agent SET {sets} WHERE id=?",
                     (*fields.values(), aid))

    def delete_agent(self, aid: str) -> None:
        self.execute("DELETE FROM agent WHERE id=?", (aid,))

    # -- audit ---------------------------------------------------------------------------

    def add_audit(self, user: str, path: str, method: str, status_code: int,
                  latency_ms: float, request: str = "", response: str = "",
                  resource_type: str = "", resource_id: str = "") -> None:
        self.execute(
            "INSERT INTO audit_log (user,path,method,status_code,latency_ms,request,"
            "response,resource_type,resource_id,created) VALUES (?,?,?,?,?,?,?,?,?,?)",
            (user, path, method, status_code, latency_ms, request[:4000],
             response[:4000], resource_type, resource_id, _now()),
        )

    def list_audit(self, user: Optional[str] = None, limit: int = 100,
                   offset: int = 0) -> list[dict]:
        if user:
            return self.query(
                "SELECT * FROM audit_log WHERE user=? ORDER BY id DESC LIMIT ? OFFSET ?",
                (user, limit, offset),
            )
        return self.query(
            "SELECT * FROM audit_log ORDER BY id DESC LIMIT ? OFFSET ?",
            (limit, offset),
        )

    def get_audit(self, audit_id: int) -> Optional[dict]:
        return self.query_one("SELECT * FROM audit_log WHERE id=?", (audit_id,))

    # -- direct collection sharing (reference api/collections.py:62-120) --------

    def share_collection(self, collection_id: str, user: str,
                         granted_by: str) -> dict:
        sid = new_id("shr")
        self.execute(
            "INSERT OR IGNORE INTO collection_share"
            " (id,collection_id,user,granted_by,created) VALUES (?,?,?,?,?)",
            (sid, collection_id, user, granted_by, _now()),
        )
        return self.query_one(
            "SELECT * FROM collection_share WHERE collection_id=? AND user=?",
            (collection_id, user),
        )

    def unshare_collection(self, collection_id: str, user: str) -> None:
        self.execute(
            "DELETE FROM collection_share WHERE collection_id=? AND user=?",
            (collection_id, user),
        )

    def list_collection_shares(self, collection_id: str) -> list[dict]:
        return self.query(
            "SELECT * FROM collection_share WHERE collection_id=?",
            (collection_id,),
        )

    def is_shared_with(self, collection_id: str, user: str) -> bool:
        return self.query_one(
            "SELECT id FROM collection_share WHERE collection_id=? AND user=?",
            (collection_id, user),
        ) is not None

    def list_shared_collections(self, user: str) -> list[dict]:
        rows = self.query(
            "SELECT c.* FROM collection_share s JOIN collection c"
            " ON c.id=s.collection_id WHERE s.user=? AND c.status != 'DELETED'",
            (user,),
        )
        for r in rows:
            r["config"] = json.loads(r["config"])
        return rows

    # -- marketplace -----------------------------------------------------------------------

    def publish_collection(self, collection_id: str) -> dict:
        mid = new_id("mkt")
        self.execute(
            "INSERT INTO marketplace (id,collection_id,published_at) VALUES (?,?,?)"
            " ON CONFLICT(collection_id) DO UPDATE SET status='PUBLISHED',"
            " published_at=excluded.published_at",
            (mid, collection_id, _now()),
        )
        return self.query_one(
            "SELECT * FROM marketplace WHERE collection_id=?", (collection_id,)
        )

    def unpublish_collection(self, collection_id: str) -> None:
        self.execute(
            "UPDATE marketplace SET status='UNPUBLISHED' WHERE collection_id=?",
            (collection_id,),
        )

    def list_marketplace(self) -> list[dict]:
        return self.query(
            "SELECT m.*, c.title, c.description, c.user AS owner FROM marketplace m"
            " JOIN collection c ON c.id = m.collection_id WHERE m.status='PUBLISHED'"
            " ORDER BY m.published_at DESC"
        )

    def subscribe(self, user: str, collection_id: str) -> dict:
        sid = new_id("sub")
        self.execute(
            "INSERT OR IGNORE INTO subscription (id,user,collection_id,created)"
            " VALUES (?,?,?,?)",
            (sid, user, collection_id, _now()),
        )
        return self.query_one(
            "SELECT * FROM subscription WHERE user=? AND collection_id=?",
            (user, collection_id),
        )

    def unsubscribe(self, user: str, collection_id: str) -> None:
        self.execute(
            "DELETE FROM subscription WHERE user=? AND collection_id=?",
            (user, collection_id),
        )

    def list_subscriptions(self, user: str) -> list[dict]:
        return self.query(
            "SELECT s.*, c.title FROM subscription s JOIN collection c"
            " ON c.id=s.collection_id WHERE s.user=? ORDER BY s.created DESC",
            (user,),
        )

    def is_subscribed(self, user: str, collection_id: str) -> bool:
        return (
            self.query_one(
                "SELECT id FROM subscription WHERE user=? AND collection_id=?",
                (user, collection_id),
            )
            is not None
        )

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class _Txn:
    def __init__(self, db: Database):
        self.db = db

    def __enter__(self):
        self.db._lock.acquire()
        self.db._conn.execute("BEGIN")
        return self.db

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self.db._conn.execute("COMMIT")
            else:
                self.db._conn.execute("ROLLBACK")
        finally:
            self.db._lock.release()
        return False
