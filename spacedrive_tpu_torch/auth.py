"""OAuth device-flow auth plane (RFC 8628), kept locally.

Port of ``spacedrive_tpu/auth.py`` (upstream core/src/auth.rs,
core/src/api/auth.rs:35-174): ``auth.loginSession`` asks the issuer for a
device code, streams Start{user_code, verification urls}, polls the
device-code grant until the user approves, stores the ``OAuthToken`` in
the node config; ``auth.me`` exchanges it for {id, email}; ``auth.logout``
clears it. The node reaches no hosted issuer: ``DeviceFlowIssuer`` is the
in-process issuer with the three endpoint behaviours (device-code minting,
the authorization_pending / access_denied / expired_token poll protocol,
bearer-token lookup). An HTTP adapter with the same methods can take its
place as ``node.auth_issuer``.
"""

from __future__ import annotations

import secrets
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

DEVICE_CODE_URN = "urn:ietf:params:oauth:grant-type:device_code"


@dataclass
class OAuthToken:
    """auth.rs:4-15."""

    access_token: str
    refresh_token: str
    token_type: str = "Bearer"
    expires_in: int = 3600

    def to_header(self) -> str:
        return f"{self.token_type} {self.access_token}"

    def to_raw(self) -> dict:
        return {"access_token": self.access_token,
                "refresh_token": self.refresh_token,
                "token_type": self.token_type,
                "expires_in": self.expires_in}

    @classmethod
    def from_raw(cls, raw: dict) -> "OAuthToken":
        return cls(raw["access_token"], raw["refresh_token"],
                   raw.get("token_type", "Bearer"),
                   int(raw.get("expires_in", 3600)))


def _user_code() -> str:
    alphabet = "BCDFGHJKLMNPQRSTVWXZ"  # no vowels: no accidental words
    return ("".join(secrets.choice(alphabet) for _ in range(4)) + "-"
            + "".join(secrets.choice(alphabet) for _ in range(4)))


class DeviceFlowIssuer:
    """In-process issuer: the serverside of RFC 8628 the reference's
    hosted API provides. Sessions expire after `ttl` seconds."""

    def __init__(self, verification_url: str = "https://auth.invalid/activate",
                 ttl: float = 600.0):
        self.verification_url = verification_url
        self.ttl = ttl
        # device_code → session dict
        self._sessions: Dict[str, dict] = {}
        # access_token → {"id", "email"}
        self._tokens: Dict[str, dict] = {}

    # -- POST /login/device/code -------------------------------------------

    def device_code(self, client_id: str) -> dict:
        device_code = secrets.token_urlsafe(24)
        user_code = _user_code()
        self._sessions[device_code] = {
            "client_id": client_id, "user_code": user_code,
            "state": "pending", "user": None,
            "expires_at": time.monotonic() + self.ttl,
        }
        return {
            "device_code": device_code,
            "user_code": user_code,
            "verification_url": self.verification_url,
            "verification_uri_complete":
                f"{self.verification_url}?user_code={user_code}",
        }

    # -- the user's browser step -------------------------------------------

    def approve(self, user_code: str, user_id: str, email: str) -> bool:
        s = self._by_user_code(user_code)
        if s is None or s["state"] != "pending":
            return False
        s["state"] = "approved"
        s["user"] = {"id": user_id, "email": email}
        return True

    def deny(self, user_code: str) -> bool:
        s = self._by_user_code(user_code)
        if s is None or s["state"] != "pending":
            return False
        s["state"] = "denied"
        return True

    def _by_user_code(self, user_code: str) -> Optional[dict]:
        for s in self._sessions.values():
            if s["user_code"] == user_code:
                return s
        return None

    # -- POST /login/oauth/access_token ------------------------------------

    def access_token(self, grant_type: str, device_code: str,
                     client_id: str) -> Tuple[int, dict]:
        """(status, body) mirroring the endpoint the reference polls
        (api/auth.rs:80-128): 200 + token JSON on approval, 400 +
        {"error": ...} for the pending/denied/expired protocol."""
        if grant_type != DEVICE_CODE_URN:
            return 400, {"error": "unsupported_grant_type"}
        s = self._sessions.get(device_code)
        if s is None or s["client_id"] != client_id:
            return 400, {"error": "invalid_grant"}
        if time.monotonic() > s["expires_at"]:
            self._sessions.pop(device_code, None)
            return 400, {"error": "expired_token"}
        if s["state"] == "pending":
            return 400, {"error": "authorization_pending"}
        if s["state"] == "denied":
            self._sessions.pop(device_code, None)
            return 400, {"error": "access_denied"}
        token = OAuthToken(access_token=secrets.token_urlsafe(24),
                           refresh_token=secrets.token_urlsafe(24))
        self._tokens[token.access_token] = s["user"]
        self._sessions.pop(device_code, None)
        return 200, token.to_raw()

    # -- GET /api/v1/user/me -----------------------------------------------

    def me(self, authorization_header: Optional[str]) -> Optional[dict]:
        if not authorization_header:
            return None
        parts = authorization_header.split(" ", 1)
        if len(parts) != 2 or parts[0] != "Bearer":
            return None
        return self._tokens.get(parts[1])

    def revoke(self, access_token: str) -> None:
        self._tokens.pop(access_token, None)


def issuer_for(node) -> DeviceFlowIssuer:
    """The node's issuer endpoint surface (lazily built; tests and
    future HTTP adapters may assign `node.auth_issuer` directly)."""
    issuer = getattr(node, "auth_issuer", None)
    if issuer is None:
        issuer = DeviceFlowIssuer()
        node.auth_issuer = issuer
    return issuer


def stored_token(node) -> Optional[OAuthToken]:
    raw = node.config.raw.get("auth_token")
    return OAuthToken.from_raw(raw) if raw else None


def store_token(node, token: Optional[OAuthToken]) -> None:
    node.config.raw["auth_token"] = token.to_raw() if token else None
    node.config.save()
