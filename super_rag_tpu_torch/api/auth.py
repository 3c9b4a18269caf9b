"""Authentication: JWT cookies/bearer + API keys, stdlib crypto (port of
the JAX package's api/auth.py: with the same secret, a token either
package signs verifies in the other).

Counterpart of the reference's fastapi-users integration
(super_rag/api/auth.py): JWT cookie strategy :121-123, API-key auth :202,
optional_user/required_user dependencies :234-255, register/login/logout
:269-371.  HS256 JWTs via hmac, passwords via hashlib.scrypt.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from typing import Optional

from super_rag_tpu_torch.api.http import HttpError, Request
from super_rag_tpu_torch.store.db import Database

COOKIE_NAME = "super_rag_auth"


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def hash_password(password: str, salt: Optional[bytes] = None) -> str:
    salt = salt or os.urandom(16)
    digest = hashlib.scrypt(password.encode(), salt=salt, n=2**14, r=8, p=1)
    return _b64(salt) + "$" + _b64(digest)


def verify_password(password: str, stored: str) -> bool:
    try:
        salt_s, digest_s = stored.split("$", 1)
        salt, digest = _unb64(salt_s), _unb64(digest_s)
    except ValueError:
        return False
    candidate = hashlib.scrypt(password.encode(), salt=salt, n=2**14, r=8, p=1)
    return hmac.compare_digest(candidate, digest)


def make_jwt(payload: dict, secret: str, ttl_s: int) -> str:
    header = {"alg": "HS256", "typ": "JWT"}
    body = {**payload, "exp": int(time.time()) + ttl_s, "iat": int(time.time())}
    signing = _b64(json.dumps(header).encode()) + "." + _b64(
        json.dumps(body).encode()
    )
    sig = hmac.new(secret.encode(), signing.encode(), hashlib.sha256).digest()
    return signing + "." + _b64(sig)


def decode_jwt(token: str, secret: str) -> Optional[dict]:
    try:
        h, b, s = token.split(".")
        signing = f"{h}.{b}"
        expected = hmac.new(
            secret.encode(), signing.encode(), hashlib.sha256
        ).digest()
        if not hmac.compare_digest(expected, _unb64(s)):
            return None
        payload = json.loads(_unb64(b))
        if payload.get("exp", 0) < time.time():
            return None
        return payload
    except Exception:  # noqa: BLE001 — any malformed token is unauthenticated
        return None


def _default_fetch_json(url: str, data: Optional[dict] = None,
                        headers: Optional[dict] = None) -> dict:
    """Minimal stdlib HTTP JSON helper for the OAuth code exchange."""
    import urllib.parse
    import urllib.request

    body = urllib.parse.urlencode(data).encode() if data is not None else None
    req = urllib.request.Request(url, data=body, headers={
        "Accept": "application/json", **(headers or {}),
    })
    with urllib.request.urlopen(req, timeout=20) as resp:  # noqa: S310
        return json.loads(resp.read().decode())


class Auth:
    def __init__(self, db: Database, secret: str, ttl_hours: int = 72,
                 oauth_providers: Optional[dict] = None):
        self.db = db
        self.secret = secret
        self.ttl_s = ttl_hours * 3600
        # {name: {client_id, client_secret, authorize_url, token_url,
        #         userinfo_url, scope?, id_field?, username_field?}}
        # (reference: fastapi-users OAuth accounts, db/models.py:108-143)
        self.oauth_providers = oauth_providers or {}
        self._fetch_json = _default_fetch_json  # injectable for tests

    # -- oauth (authorization-code flow) ----------------------------------------

    def _oauth_cfg(self, provider: str) -> dict:
        cfg = self.oauth_providers.get(provider)
        if cfg is None:
            raise HttpError(404, f"unknown oauth provider {provider!r}")
        return cfg

    def oauth_authorize_url(self, provider: str, redirect_uri: str) -> dict:
        import urllib.parse

        cfg = self._oauth_cfg(provider)
        state = _b64(os.urandom(16))
        # state is signed so the callback can verify it statelessly
        signed = make_jwt({"oauth_state": state, "provider": provider},
                          self.secret, 600)
        params = urllib.parse.urlencode({
            "client_id": cfg.get("client_id", ""),
            "redirect_uri": redirect_uri,
            "response_type": "code",
            "scope": cfg.get("scope", ""),
            "state": signed,
        })
        return {"authorization_url": f"{cfg['authorize_url']}?{params}",
                "state": signed}

    def oauth_callback(self, provider: str, code: str, state: str,
                       redirect_uri: str) -> tuple[dict, str]:
        cfg = self._oauth_cfg(provider)
        payload = decode_jwt(state, self.secret) if state else None
        if not payload or payload.get("provider") != provider:
            raise HttpError(401, "invalid oauth state")
        token_resp = self._fetch_json(cfg["token_url"], data={
            "client_id": cfg.get("client_id", ""),
            "client_secret": cfg.get("client_secret", ""),
            "code": code,
            "grant_type": "authorization_code",
            "redirect_uri": redirect_uri,
        })
        access_token = token_resp.get("access_token", "")
        if not access_token:
            raise HttpError(401, "oauth code exchange failed")
        info = self._fetch_json(cfg["userinfo_url"], headers={
            "Authorization": f"Bearer {access_token}",
        })
        account_id = str(info.get(cfg.get("id_field", "id"), ""))
        if not account_id:
            raise HttpError(401, "oauth userinfo missing account id")
        email = str(info.get("email") or "")
        user = None
        acct = self.db.get_oauth_account(provider, account_id)
        if acct is not None:
            user = self.db.get_user_by_id(acct["user_id"])
        if user is None:
            base_name = str(
                info.get(cfg.get("username_field", "login"))
                or (email.split("@")[0] if email else "")
                or f"{provider}_{account_id}"
            )
            username = base_name
            n = 1
            while self.db.get_user(username) is not None:
                n += 1
                username = f"{base_name}{n}"
            role = "user" if self.db.list_users() else "admin"
            user = self.db.create_user(
                username, hash_password(_b64(os.urandom(24))), email, role
            )
            self.db.add_oauth_account(
                user["id"], provider, account_id, email, access_token
            )
        else:
            self.db.update_oauth_token(provider, account_id, access_token)
        if not user["is_active"]:
            raise HttpError(403, "account disabled")
        token = make_jwt(
            {"sub": user["id"], "username": user["username"],
             "role": user["role"]},
            self.secret, self.ttl_s,
        )
        return self._public(user), token

    # -- account ops ---------------------------------------------------------

    def register(self, username: str, password: str, email: str = "",
                 role: str = "user") -> dict:
        if not username or not password:
            raise HttpError(422, "username and password required")
        if self.db.get_user(username) is not None:
            raise HttpError(409, f"user {username!r} already exists")
        # first account becomes admin (bootstrap, like the reference's
        # initial admin seeding)
        if not self.db.list_users():
            role = "admin"
        user = self.db.create_user(username, hash_password(password), email, role)
        return self._public(user)

    def login(self, username: str, password: str) -> tuple[dict, str]:
        user = self.db.get_user(username)
        if user is None or not verify_password(password, user["password_hash"]):
            raise HttpError(401, "invalid credentials")
        if not user["is_active"]:
            raise HttpError(403, "account disabled")
        token = make_jwt(
            {"sub": user["id"], "username": user["username"],
             "role": user["role"]},
            self.secret, self.ttl_s,
        )
        return self._public(user), token

    @staticmethod
    def _public(user: dict) -> dict:
        return {k: user[k] for k in ("id", "username", "email", "role")}

    # -- request resolution ------------------------------------------------------

    def resolve(self, req: Request) -> Optional[dict]:
        """Returns the authenticated user dict or None."""
        authz = req.headers.get("authorization", "")
        if authz.lower().startswith("bearer "):
            token = authz[7:].strip()
            if token.startswith("sk-"):
                rec = self.db.get_api_key(token)
                if rec:
                    user = self.db.get_user_by_id(rec["user"]) or self.db.get_user(
                        rec["user"]
                    )
                    if user:
                        return self._public(user)
                return None
            payload = decode_jwt(token, self.secret)
            if payload:
                user = self.db.get_user_by_id(payload["sub"])
                if user and user["is_active"]:
                    return self._public(user)
            return None
        cookie = req.cookie(COOKIE_NAME)
        if cookie:
            payload = decode_jwt(cookie, self.secret)
            if payload:
                user = self.db.get_user_by_id(payload["sub"])
                if user and user["is_active"]:
                    return self._public(user)
        return None

    def required(self, req: Request) -> dict:
        user = self.resolve(req)
        if user is None:
            raise HttpError(401, "authentication required")
        return user

    def required_admin(self, req: Request) -> dict:
        user = self.required(req)
        if user["role"] != "admin":
            raise HttpError(403, "admin role required")
        return user
