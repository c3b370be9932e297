"""Client Management (paper §V): User Management, Client Registration,
Client Registry — plus the §VII device-token authentication process:

  1. company signs up -> user account (governance website login)
  2. contract completed -> each participant's device gets a token
  3. device uses the token on every message
  4. server validates tokens via the registry; tokens rotate per FL run
"""
from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core import crypto
from repro_torch.core.metadata import MetadataStore


@dataclass
class UserAccount:
    username: str
    organization: str
    password_hash: str
    role: str = "participant"       # participant | server_admin
    created_at: float = field(default_factory=time.time)


@dataclass
class RegisteredClient:
    client_id: str
    organization: str
    owner: str                      # username that vouches for the device
    token: Optional[str] = None     # current device token (rotates per run)
    status: str = "pending"         # pending | active | revoked
    registered_at: float = field(default_factory=time.time)


class ClientManagement:
    def __init__(self, metadata: MetadataStore):
        self.metadata = metadata
        self.users: Dict[str, UserAccount] = {}
        self.registry: Dict[str, RegisteredClient] = {}

    # ------------------------------------------------------------------
    # User Management
    # ------------------------------------------------------------------
    def create_user(self, admin: str, username: str, organization: str,
                    password: str, role: str = "participant") -> UserAccount:
        if username in self.users:
            raise ValueError(f"user {username} exists")
        acct = UserAccount(username, organization,
                           crypto.hash_password(password), role)
        self.users[username] = acct
        self.metadata.record_provenance(
            actor=admin, operation="create_user", subject=username,
            outcome="created", details={"organization": organization,
                                        "role": role})
        return acct

    def authenticate_user(self, username: str, password: str) -> bool:
        acct = self.users.get(username)
        ok = bool(acct and crypto.verify_password(password,
                                                  acct.password_hash))
        self.metadata.record_provenance(
            actor=username, operation="login", subject="website",
            outcome="success" if ok else "failure")
        return ok

    # ------------------------------------------------------------------
    # Client Registration -> Registry
    # ------------------------------------------------------------------
    def request_registration(self, owner: str, organization: str) -> str:
        """A participant registers their training device; validated before
        it enters the registry (paper: 'accepts registration requests and
        validates them')."""
        if owner not in self.users:
            raise PermissionError(f"unknown user {owner}")
        if self.users[owner].organization != organization:
            raise PermissionError("user does not belong to organization")
        client_id = f"client-{uuid.uuid4().hex[:8]}"
        self.registry[client_id] = RegisteredClient(
            client_id=client_id, organization=organization, owner=owner)
        self.metadata.record_provenance(
            actor=owner, operation="register_client", subject=client_id,
            outcome="pending", details={"organization": organization})
        return client_id

    def approve_client(self, admin: str, client_id: str):
        c = self.registry[client_id]
        c.status = "active"
        self.metadata.record_provenance(
            actor=admin, operation="approve_client", subject=client_id,
            outcome="active")

    def revoke_client(self, admin: str, client_id: str, reason: str = ""):
        c = self.registry[client_id]
        c.status = "revoked"
        c.token = None
        self.metadata.record_provenance(
            actor=admin, operation="revoke_client", subject=client_id,
            outcome="revoked", details={"reason": reason})

    # ------------------------------------------------------------------
    # Device tokens (rotate every FL run — §VII)
    # ------------------------------------------------------------------
    def issue_tokens(self, run_id: str) -> Dict[str, str]:
        issued = {}
        for c in self.registry.values():
            if c.status == "active":
                c.token = crypto.new_device_token()
                issued[c.client_id] = c.token
        self.metadata.record_provenance(
            actor="client_management", operation="issue_tokens",
            subject=run_id, outcome="issued",
            details={"clients": sorted(issued)})
        return issued

    def ensure_token(self, client_id: str) -> str:
        """Issue a device token for one silo unless it already holds a live
        one. The federation scheduler multiplexes a silo's single identity
        across concurrent runs, so tokens rotate per *agent lease epoch*
        (registration), not per run — rotating mid-run would cut off every
        other job the silo is serving."""
        c = self.registry.get(client_id)
        if c is None or c.status != "active":
            raise PermissionError(f"{client_id} is not an active client")
        if not c.token:
            c.token = crypto.new_device_token()
            self.metadata.record_provenance(
                actor="client_management", operation="issue_token",
                subject=client_id, outcome="issued",
                details={"scope": "agent_lease"})
        return c.token

    def validate_token(self, client_id: str, token: str) -> bool:
        c = self.registry.get(client_id)
        return bool(c and c.status == "active" and c.token
                    and c.token == token)

    def active_clients(self) -> List[str]:
        return sorted(c.client_id for c in self.registry.values()
                      if c.status == "active")

    def check_registered(self, client_ids: List[str]) -> Dict[str, bool]:
        """SAAM task 25: check registered clients."""
        return {cid: (cid in self.registry
                      and self.registry[cid].status == "active")
                for cid in client_ids}
