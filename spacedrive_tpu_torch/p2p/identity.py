"""Ed25519 node and instance identities.

Port of ``spacedrive_tpu/p2p/identity.py`` (upstream
crates/p2p/src/spacetunnel/identity.rs:19-60) on the port's own Ed25519
(``p2p/_crypto.py``). An ``Identity`` is a keypair kept as its 32-byte
raw seed, so ``to_bytes()`` gives what ``cryptography`` serialises and
one identity file serves either package; its public half
(``RemoteIdentity``, 32 raw bytes) is how peers and library instances
are addressed and verified.
"""

from __future__ import annotations

import os
from typing import Optional

from . import _crypto


class RemoteIdentity:
    """A peer's public identity (32 raw bytes)."""

    def __init__(self, public_bytes: bytes):
        if len(public_bytes) != 32:
            raise ValueError("an Ed25519 public key is 32 bytes")
        self._raw = bytes(public_bytes)

    def to_bytes(self) -> bytes:
        return self._raw

    def verify(self, signature: bytes, message: bytes) -> bool:
        return _crypto.ed25519_verify(self._raw, message, signature)

    def __eq__(self, other) -> bool:
        return isinstance(other, RemoteIdentity) and self._raw == other._raw

    def __hash__(self) -> int:
        return hash(self._raw)

    def __repr__(self) -> str:
        return f"RemoteIdentity({self._raw.hex()[:12]}…)"


class Identity:
    def __init__(self, private_bytes: Optional[bytes] = None):
        if private_bytes is None:
            private_bytes = os.urandom(32)
        if len(private_bytes) != 32:
            raise ValueError("an Ed25519 private key is a 32-byte seed")
        self._seed = bytes(private_bytes)
        self._public: Optional[bytes] = None

    def to_bytes(self) -> bytes:
        return self._seed

    def to_remote_identity(self) -> RemoteIdentity:
        if self._public is None:
            self._public = _crypto.ed25519_public(self._seed)
        return RemoteIdentity(self._public)

    def sign(self, message: bytes) -> bytes:
        return _crypto.ed25519_sign(self._seed, message)
