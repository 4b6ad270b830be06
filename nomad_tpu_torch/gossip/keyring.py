"""Gossip encryption keyring (ref serf's keyring + `nomad operator keygen`
/ `agent keyring` surface): AES-GCM seals every UDP gossip frame. The
keyring holds multiple keys so rotation is zero-downtime — the primary
encrypts, every installed key is tried for decryption, and packets that
authenticate under none are dropped (an unencrypted or wrong-key peer
simply never merges)."""

from __future__ import annotations

import base64
import os
import threading

from cryptography.hazmat.primitives.ciphers.aead import AESGCM

NONCE_LEN = 12
KEY_LEN = 32


def generate_key() -> str:
    """Base64 of a fresh 256-bit key (ref `nomad operator keygen`)."""
    return base64.b64encode(os.urandom(KEY_LEN)).decode()


def _decode(key: str) -> bytes:
    raw = base64.b64decode(key)
    if len(raw) not in (16, 24, 32):
        raise ValueError("gossip key must be 16/24/32 bytes of base64")
    return raw


class Keyring:
    """Primary + installed keys with serf's use/install/remove semantics.
    With ``path`` the ring persists as JSON (serf's keyring file role), so
    keys installed at runtime survive agent restarts."""

    def __init__(self, primary: str, path: str = ""):
        raw = _decode(primary)
        self._lock = threading.Lock()
        self._keys: dict[str, bytes] = {primary: raw}
        self._primary = primary
        self._path = path
        if path:
            self._load()

    def _load(self):
        import json

        try:
            with open(self._path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return
        with self._lock:
            for key in doc.get("keys", []):
                try:
                    self._keys[key] = _decode(key)
                except Exception:
                    continue
            primary = doc.get("primary")
            if primary in self._keys:
                self._primary = primary

    def _persist_locked(self):
        if not self._path:
            return
        import json
        import tempfile

        doc = {"primary": self._primary, "keys": list(self._keys)}
        d = os.path.dirname(self._path) or "."
        try:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".keyring-")
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.chmod(tmp, 0o600)
            os.replace(tmp, self._path)
        except OSError:
            pass

    # -- management (ref serf keyring InstallKey/UseKey/RemoveKey/List) --
    def install(self, key: str):
        raw = _decode(key)
        with self._lock:
            self._keys[key] = raw
            self._persist_locked()

    def use(self, key: str):
        with self._lock:
            if key not in self._keys:
                raise KeyError("key is not installed")
            self._primary = key
            self._persist_locked()

    def remove(self, key: str):
        with self._lock:
            if key == self._primary:
                raise ValueError("cannot remove the primary key")
            self._keys.pop(key, None)
            self._persist_locked()

    def list_keys(self) -> dict:
        with self._lock:
            return {"PrimaryKey": self._primary, "Keys": list(self._keys)}

    # -- framing ---------------------------------------------------------
    def seal(self, plaintext: bytes) -> bytes:
        with self._lock:
            raw = self._keys[self._primary]
        nonce = os.urandom(NONCE_LEN)
        return nonce + AESGCM(raw).encrypt(nonce, plaintext, b"")

    def open(self, frame: bytes) -> bytes | None:
        """Plaintext, or None when no installed key authenticates it."""
        if len(frame) <= NONCE_LEN:
            return None
        nonce, ct = frame[:NONCE_LEN], frame[NONCE_LEN:]
        with self._lock:
            candidates = list(self._keys.values())
        for raw in candidates:
            try:
                return AESGCM(raw).decrypt(nonce, ct, b"")
            except Exception:
                continue
        return None
