"""Vault integration: task token derivation + accessor lifecycle
(ref nomad/vault.go: DeriveVaultToken, accessor tracking, revocation on
alloc termination).

The reference talks to a real Vault server through a renewable management
token. Here the token LIFECYCLE is implemented against a pluggable
provider: ``InternalProvider`` mints standalone secrets (the zero-
dependency default, suitable for dev and for the secret-delivery contract
tests), and a real-Vault provider only needs create/revoke against the
external API. Accessors replicate through raft so a new leader can keep
revoking; tokens themselves never enter server state — only the client's
secrets dir."""

from __future__ import annotations

import logging
import threading
from typing import Optional, Protocol

from ..structs.model import generate_uuid

logger = logging.getLogger("nomad_tpu.vault")


class VaultProvider(Protocol):
    def create_token(self, policies: list[str]) -> tuple[str, str]:
        """→ (secret token, accessor)"""
        ...

    def revoke_accessor(self, accessor: str) -> None: ...


class InternalProvider:
    """Standalone token mint (dev mode / tests): uuid secrets, revocation
    is bookkeeping only."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: dict[str, str] = {}  # accessor -> token

    def create_token(self, policies: list[str]) -> tuple[str, str]:
        token = f"s.{generate_uuid()}"
        accessor = generate_uuid()
        with self._lock:
            self._live[accessor] = token
        return token, accessor

    def revoke_accessor(self, accessor: str) -> None:
        with self._lock:
            self._live.pop(accessor, None)

    def is_live(self, accessor: str) -> bool:
        with self._lock:
            return accessor in self._live


class HTTPProvider:
    """Real-Vault provider: token create/revoke against an external Vault
    server with a renewable management token (ref nomad/vault.go
    vaultClient: establishConnection + renewal loop + CreateToken +
    RevokeTokens)."""

    def __init__(
        self,
        address: str,
        token: str,
        renew_interval: float = 300.0,
        timeout: float = 10.0,
        backoff_base: float = 1.0,
    ):
        self.address = address.rstrip("/")
        self.token = token
        self.renew_interval = renew_interval
        self.timeout = timeout
        #: first retry delay after a failed renewal; doubles per
        #: consecutive failure up to renew_interval (ref nomad/vault.go
        #: renewal loop backoff)
        self.backoff_base = backoff_base
        #: consecutive renewal failures; reset on success. Exposed so
        #: operators (and tests) can observe the loop degrading.
        self.consecutive_failures = 0
        self.last_renewal_error: Optional[str] = None
        self._stop = threading.Event()
        self._renewer: Optional[threading.Thread] = None

    def _req(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        import json
        import urllib.error
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            f"{self.address}/v1/{path.lstrip('/')}",
            data=data,
            method=method,
            headers={"X-Vault-Token": self.token},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("errors", [str(e)])
            except Exception:
                detail = [str(e)]
            raise RuntimeError(f"vault {path}: {'; '.join(map(str, detail))}")
        except (urllib.error.URLError, OSError) as e:
            # timeouts and connection refusals surface as retriable vault
            # errors, not raw socket tracebacks (the renewal loop backoff
            # and the derive path both key off this)
            raise RuntimeError(f"vault {path}: {e}")

    # -- VaultProvider surface -----------------------------------------
    def create_token(self, policies: list[str]) -> tuple[str, str]:
        doc = self._req(
            "POST",
            "auth/token/create",
            {
                "policies": list(policies),
                # task tokens must outlive the management connection and
                # die on their own TTL, like the reference's role tokens
                "no_parent": True,
                "renewable": True,
            },
        )
        auth = doc.get("auth") or {}
        token = auth.get("client_token", "")
        accessor = auth.get("accessor", "")
        if not token or not accessor:
            raise RuntimeError("vault create_token: malformed auth response")
        return token, accessor

    def revoke_accessor(self, accessor: str) -> None:
        self._req("POST", "auth/token/revoke-accessor", {"accessor": accessor})

    # -- management-token renewal (vault.go renewal loop) --------------
    def renew_self(self) -> None:
        self._req("POST", "auth/token/renew-self", {})

    def start_renewal(self):
        if self._renewer is not None:
            return

        def loop():
            # healthy cadence is renew_interval; a failure switches to an
            # exponential backoff (base, 2*base, 4*base, ... capped at the
            # interval) so a flapping Vault is retried promptly without
            # being hammered, and success restores the normal cadence
            # (ref nomad/vault.go renewal loop)
            delay = self.renew_interval
            while not self._stop.wait(delay):
                try:
                    self.renew_self()
                    self.consecutive_failures = 0
                    self.last_renewal_error = None
                    delay = self.renew_interval
                except Exception as e:
                    self.consecutive_failures += 1
                    self.last_renewal_error = str(e)
                    delay = min(
                        self.backoff_base
                        * (2 ** (self.consecutive_failures - 1)),
                        self.renew_interval,
                    )
                    logger.warning(
                        "vault token renewal failed (attempt %d, retry in "
                        "%.1fs): %s",
                        self.consecutive_failures, delay, e,
                    )

        self._renewer = threading.Thread(
            target=loop, daemon=True, name="vault-renewal"
        )
        self._renewer.start()

    def stop(self):
        self._stop.set()


def provider_from_config(config: dict) -> "VaultProvider":
    """vault{enabled, address, token} in the server config selects the
    real-Vault HTTP provider (with background self-renewal); without an
    address — or with enabled=false, the documented way to switch the
    integration off while keeping the stanza — the self-minting internal
    provider serves instead (and VaultClient.enabled() gates derivation)."""
    vcfg = config.get("vault", {}) or {}
    if vcfg.get("address") and vcfg.get("enabled", True):
        provider = HTTPProvider(
            vcfg["address"],
            vcfg.get("token", ""),
            renew_interval=float(vcfg.get("renew_interval_s", 300.0)),
            backoff_base=float(vcfg.get("renew_backoff_s", 1.0)),
        )
        provider.start_renewal()
        return provider
    return InternalProvider()


class VaultClient:
    """Server-side vault workflow (ref vault.go vaultClient)."""

    def __init__(self, server, provider: Optional[VaultProvider] = None):
        self.server = server
        self.provider = provider or provider_from_config(
            getattr(server, "config", {}) or {}
        )

    def enabled(self) -> bool:
        return bool(self.server.config.get("vault", {}).get("enabled"))

    # ------------------------------------------------------------------
    def derive_token(self, alloc_id: str, task_name: str) -> str:
        """Create a token for a task's vault stanza and track its accessor
        (ref node_endpoint.go DeriveVaultToken → vault.go CreateToken)."""
        if not self.enabled():
            raise ValueError("vault integration is disabled")
        alloc = self.server.state.alloc_by_id(alloc_id)
        if alloc is None:
            raise KeyError(f"alloc not found: {alloc_id}")
        job = alloc.job
        tg = job.lookup_task_group(alloc.task_group) if job else None
        task = None
        if tg is not None:
            task = next((t for t in tg.tasks if t.name == task_name), None)
        if task is None or task.vault is None:
            raise ValueError(
                f"task {task_name!r} does not declare a vault stanza"
            )
        token, accessor = self.provider.create_token(list(task.vault.policies))
        from . import fsm as fsm_mod

        self.server._apply(
            fsm_mod.VAULT_ACCESSOR_UPSERT,
            {
                "accessors": [
                    {
                        "accessor": accessor,
                        "alloc_id": alloc_id,
                        "task": task_name,
                        "node_id": alloc.node_id,
                    }
                ]
            },
        )
        return token

    # ------------------------------------------------------------------
    def revoke_for_allocs(self, alloc_ids: list[str]):
        """Revoke every accessor tied to the given allocs (the reference
        revokes when allocs terminate/GC, vault.go RevokeTokens)."""
        ids = set(alloc_ids)
        targets = [
            a["accessor"]
            for a in self.server.state.vault_accessors()
            if a["alloc_id"] in ids
        ]
        if not targets:
            return
        for accessor in targets:
            try:
                self.provider.revoke_accessor(accessor)
            except Exception:
                logger.exception("vault revoke failed for %s", accessor)
        from . import fsm as fsm_mod
        from .core_sched import MAX_IDS_PER_REAP

        # bounded raft entries, like every other reap path
        for start in range(0, len(targets), MAX_IDS_PER_REAP):
            self.server._apply(
                fsm_mod.VAULT_ACCESSOR_DELETE,
                {"accessors": targets[start : start + MAX_IDS_PER_REAP]},
            )
