"""Communicator (paper §V/§VI) — pull-based, encrypted, compressed.

Requirement 6 (§III): *"An external server is not allowed to send messages
that start operations within the company infrastructure."* The server
therefore never calls into clients. It publishes resources on a message
board; clients **poll** (`fetch`) and **post** their own resources. This is
the REST-resource pattern the paper sketches in §VIII.

Every payload is msgpack-serialized, zlib-compressed, encrypted and
authenticated with a per-client channel key (crypto.py). Client posts carry
the device token; the board validates it against Client Management before
accepting (paper §VII step 3-4). Server resources carry a server certificate
clients can verify (§VII Server Authentication).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from repro_torch.core import crypto, serialization
from repro_torch.core.clients import ClientManagement
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.transport import (InProcTransport, Resource, Transport,
                                  WanModel)


def _run_of(path: str) -> Optional[str]:
    """Run namespace of a board path (``runs/<rid>/...``), or None."""
    if path.startswith("runs/"):
        end = path.find("/", 5)
        if end > 5:
            return path[5:end]
    return None

__all__ = ["Resource", "MessageBoard", "ServerCommunicator",
           "ClientCommunicator"]


class MessageBoard:
    """Policy shell over a pluggable :class:`Transport` backend.

    The board used to *be* the storage (one dict, one class); it is now
    split in two layers (DESIGN.md §Transport layer): the transport
    stores ciphertext + resource metadata and owns the board-wide
    monotonic mutation counter (``seq``), while this shell keeps
    everything the paper assigns to the coordinator's trust boundary —
    token validation against Client Management, rejected-post
    provenance, deletion tombstones and traffic accounting. Swap the
    backend (``InProcTransport`` dict vs. ``SocketTransport`` to a
    board-hosting process) and the shell behaves identically.

    The board stores only ciphertext; it can be hosted by the
    (semi-trusted) coordinator without seeing plaintext updates. The
    federation scheduler's wake conditions compare ``seq`` against a
    snapshot to tell "something this run waits for changed" without
    decrypting anything (``latest_seq``). Runs never collide on the
    board because every run's resources live under their own
    ``runs/<run_id>/...`` namespace.
    """

    # Deleted paths keep their deletion seq so latest_seq watchers observe
    # round GC like any overwrite. Round paths are uniquely named, so the
    # tombstone map is LRU-bounded: evicted entries collapse into a floor
    # seq that unknown paths report — over-reporting only ever causes one
    # spurious (safe, cheap) wake for a watcher whose snapshot predates the
    # eviction, never a lost wake.
    TOMBSTONE_CAP = 4096

    def __init__(self, clients: ClientManagement, metadata: MetadataStore,
                 transport: Optional[Transport] = None,
                 wan: Optional[WanModel] = None,
                 telemetry: Optional[Telemetry] = None):
        self.clients = clients
        self.metadata = metadata
        self.transport = (transport if transport is not None
                          else InProcTransport(wan=wan))
        # The board anchors the federation's Telemetry bundle: every
        # component (scheduler, servers, client agents) already holds the
        # board, so they all share this instance. Disabled by default.
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.telemetry.attach_transport(self.transport)
        if self.transport.wan is not None:
            self.telemetry.attach_wan(self.transport.wan)
        self._tombstones: "OrderedDict[str, int]" = OrderedDict()
        self._tombstone_floor = 0         # max seq among evicted tombstones
        # bytes_posted counts the upload side, bytes_fetched the download
        # side (both directions cross the WAN in deployment — the cost
        # model needs both); the *_by families break traffic down per
        # actor. stat_calls/stat_probes/probes_saved account the batched
        # probe sweeps: one stat_many over k paths is 1 call, k probes,
        # k-1 saved round-trips vs. per-path stat. All live in the shared
        # metrics registry now; ``stats`` assembles the legacy dict view.
        reg = self.telemetry.metrics
        self._c_posts = reg.counter("board.posts")
        self._c_fetches = reg.counter("board.fetches")
        self._c_bytes_posted = reg.counter("board.bytes_posted")
        self._c_bytes_posted_clients = reg.counter(
            "board.bytes_posted_clients")
        self._c_bytes_fetched = reg.counter("board.bytes_fetched")
        self._c_rejected = reg.counter("board.rejected")
        self._c_deletes = reg.counter("board.deletes")
        self._c_stat_calls = reg.counter("board.stat_calls")
        self._c_stat_probes = reg.counter("board.stat_probes")
        self._c_probes_saved = reg.counter("board.probes_saved")

    @property
    def stats(self) -> dict:
        """Traffic accounting in the board's historical dict shape —
        assembled fresh from the metrics registry on every read, so a
        caller's snapshot is detached plain data (nothing shares live
        nested references with the board; mutate it freely)."""
        reg = self.telemetry.metrics
        return {"posts": self._c_posts.read(),
                "fetches": self._c_fetches.read(),
                "bytes_posted": self._c_bytes_posted.read(),
                "bytes_posted_clients": self._c_bytes_posted_clients.read(),
                "bytes_fetched": self._c_bytes_fetched.read(),
                "rejected": self._c_rejected.read(),
                "deletes": self._c_deletes.read(),
                "stat_calls": self._c_stat_calls.read(),
                "stat_probes": self._c_stat_probes.read(),
                "probes_saved": self._c_probes_saved.read(),
                "bytes_posted_by": reg.labeled("board.bytes_posted_by",
                                               "actor"),
                "bytes_fetched_by": reg.labeled("board.bytes_fetched_by",
                                                "actor")}

    @property
    def seq(self) -> int:
        """Board-wide monotonic mutation counter (owned by the transport)."""
        return self.transport.seq

    @property
    def wan(self) -> Optional[WanModel]:
        return self.transport.wan

    def close(self):
        self.transport.close()

    def _account_fetch(self, reader: str, nbytes: Optional[int]):
        self._c_fetches.inc()
        if nbytes:
            self._c_bytes_fetched.inc(nbytes)
            self.telemetry.metrics.counter("board.bytes_fetched_by",
                                           actor=reader).inc(nbytes)

    def _put(self, path: str, blob: bytes, author: str):
        self._tombstones.pop(path, None)   # a re-created path is live again
        tel = self.telemetry
        if tel.enabled:
            with tel.span("board.put", cat="rpc", actor=author,
                          run_id=_run_of(path),
                          attrs={"path": path, "bytes": len(blob)}):
                self.transport.put(path, blob, author)
        else:
            self.transport.put(path, blob, author)
        self._c_posts.inc()
        self._c_bytes_posted.inc(len(blob))
        tel.metrics.counter("board.bytes_posted_by",
                            actor=author).inc(len(blob))
        if author != "server":
            # silo-uploaded bytes: the WAN cost the compressed data plane
            # exists to shrink (bench_compression reports this counter)
            self._c_bytes_posted_clients.inc(len(blob))

    # server-side put (no token needed, done by the coordinator process)
    def put_server(self, path: str, blob: bytes):
        self._put(path, blob, "server")

    def put_client(self, client_id: str, token: str, path: str, blob: bytes):
        if not self.clients.validate_token(client_id, token):
            self._c_rejected.inc()
            self.metadata.record_provenance(
                actor=client_id, operation="post", subject=path,
                outcome="rejected_auth")
            raise PermissionError(f"invalid token for {client_id}")
        self._put(path, blob, client_id)

    def get(self, path: str, *, reader: str = "server") -> Optional[bytes]:
        tel = self.telemetry
        if tel.enabled:
            with tel.span("board.get", cat="rpc", actor=reader,
                          run_id=_run_of(path), attrs={"path": path}) as sp:
                blob = self.transport.get(path, reader=reader)
                sp.set(bytes=len(blob) if blob is not None else 0)
        else:
            blob = self.transport.get(path, reader=reader)
        self._account_fetch(reader, len(blob) if blob is not None else None)
        return blob

    def get_if_newer(self, path: str, version: int, *,
                     reader: str = "server") -> Tuple[Optional[bytes], int]:
        """Conditional fetch (HTTP ETag shape): ``(blob, version)`` when
        the stored resource is newer than ``version``, else
        ``(None, stored_version)`` — the unchanged case costs a
        metadata-only round trip, not a re-download (client pollers hit
        ``runs/<rid>/status`` every tick; it rarely changes)."""
        tel = self.telemetry
        if tel.enabled:
            with tel.span("board.get_if_newer", cat="rpc", actor=reader,
                          run_id=_run_of(path), attrs={"path": path}) as sp:
                blob, ver = self.transport.get_if_newer(path, version,
                                                        reader=reader)
                sp.set(bytes=len(blob) if blob is not None else 0,
                       hit=blob is None)
        else:
            blob, ver = self.transport.get_if_newer(path, version,
                                                    reader=reader)
        self._account_fetch(reader, len(blob) if blob is not None else None)
        return blob, ver

    def stat(self, path: str) -> Optional[dict]:
        """Resource metadata without touching the ciphertext — used by the
        server's heartbeat probes (``collect_heartbeats``): the coordinator
        can see *that* a client posted and when, never *what*."""
        self._c_stat_calls.inc()
        self._c_stat_probes.inc()
        return self.transport.stat(path)

    def stat_many(self, paths) -> Dict[str, Optional[dict]]:
        """Batched ``stat`` over a whole cohort: ONE transport call (one
        RPC round trip on the socket backend) instead of one per path —
        ``probes_saved`` counts the difference."""
        paths = list(paths)
        if not paths:
            return {}
        self._c_stat_calls.inc()
        self._c_stat_probes.inc(len(paths))
        self._c_probes_saved.inc(len(paths) - 1)
        tel = self.telemetry
        if tel.enabled:
            with tel.span("board.stat_many", cat="rpc", actor="server",
                          run_id=_run_of(paths[0]),
                          attrs={"paths": len(paths)}):
                return self.transport.stat_many(paths)
        return self.transport.stat_many(paths)

    def latest_seq(self, paths) -> int:
        """Largest mutation counter among ``paths`` (0 if none were ever
        written).

        Metadata-only, like ``stat``: one batched transport sweep answers
        "did anything this run is waiting for appear/change since
        snapshot S?" with no decryption and no polling of the payloads
        themselves. A deleted path counts with the seq of its *deletion*
        (per-path tombstone, kept board-side — the transport forgets
        deleted paths entirely): a wake snapshot taken before a round GC
        must observe that the resource changed, or the watcher would
        sleep on a path that no longer exists. Paths whose tombstone was
        LRU-evicted report the eviction floor — at worst one spurious
        wake for a very stale watcher, never a missed one."""
        paths = list(paths)
        if not paths:
            return 0
        latest = 0
        for path, meta in self.transport.stat_many(paths).items():
            seq = (meta["seq"] if meta is not None
                   else self._tombstones.get(path, self._tombstone_floor))
            if seq > latest:
                latest = seq
        return latest

    def list(self, pattern: str) -> List[str]:
        # Glob matching is fnmatchcase (byte-exact on every platform) —
        # the transport contract; InProcTransport answers from a
        # directory-prefix index, same observable semantics.
        return self.transport.list(pattern)

    def delete(self, path: str):
        """Remove a resource, leaving a per-path trace: the deletion bumps
        the board seq AND records it as the path's tombstone seq, so
        ``latest_seq`` watchers observe deletions exactly like overwrites
        (round GC must not let wake snapshots go stale). The tombstone map
        is bounded (``TOMBSTONE_CAP``): evictions fold into the floor."""
        seq = self.transport.delete(path)
        if seq is not None:
            self._tombstones[path] = seq
            self._tombstones.move_to_end(path)
            while len(self._tombstones) > self.TOMBSTONE_CAP:
                _, evicted = self._tombstones.popitem(last=False)
                self._tombstone_floor = max(self._tombstone_floor, evicted)
            self._c_deletes.inc()


class ServerCommunicator:
    """Communication Manager: per-client channel keys, encryption,
    compression (paper §V)."""

    def __init__(self, board: MessageBoard, master_key: bytes,
                 server_id: str = "fl-server"):
        self.board = board
        self.master = master_key
        self.server_id = server_id
        self.cert = crypto.server_certificate(server_id, master_key)

    def channel_key(self, client_id: str) -> bytes:
        return crypto.derive_key(self.master, f"channel/{client_id}")

    def broadcast_key(self) -> bytes:
        return crypto.derive_key(self.master, "broadcast")

    def publish(self, path: str, payload, *, client_id: Optional[str] = None):
        """Publish a resource; ``client_id=None`` = broadcast channel."""
        key = (self.channel_key(client_id) if client_id
               else self.broadcast_key())
        body = {"server_id": self.server_id, "cert": self.cert,
                "payload": payload}
        self.board.put_server(path, crypto.encrypt(key,
                                                   serialization.pack(body)))

    def collect(self, path: str, client_id: str):
        blob = self.board.get(path)
        if blob is None:
            return None
        return serialization.unpack(
            crypto.decrypt(self.channel_key(client_id), blob))

    def collect_heartbeats(self, run_id: str, cohort) -> Dict[str, int]:
        """Liveness view: client_id -> overwrite version of the latest
        heartbeat (missing clients are absent). One ``board.stat_many``
        sweep over the whole cohort — resource metadata only, no
        decryption: the coordinator sees *that* a client refreshed its
        heartbeat, never *what* it contains, and pays one transport
        round trip per tick instead of one per cohort member. The
        version is a monotonic overwrite counter, so liveness never
        depends on clock resolution. Heartbeats ride the same pull-based
        board as every other resource — the server never probes clients
        directly (requirement 6)."""
        cohort = list(cohort)
        paths = {cid: f"runs/{run_id}/heartbeat/{cid}" for cid in cohort}
        metas = self.board.stat_many(paths.values())
        return {cid: int(metas[p]["version"])
                for cid, p in paths.items() if metas[p] is not None}


class ClientCommunicator:
    """Client-side Communicator: polls the board, never receives pushes."""

    def __init__(self, board: MessageBoard, client_id: str, token: str,
                 channel_key: bytes, broadcast_key: bytes,
                 ca_key: Optional[bytes] = None):
        self.board = board
        self.client_id = client_id
        self.token = token
        self.channel_key = channel_key
        self.broadcast_key = broadcast_key
        self.ca_key = ca_key
        # path -> (seen version, decrypted payload) for fetch_cached;
        # small FIFO — clients only ever poll a handful of hot paths
        self._fetch_cache: Dict[str, tuple] = {}

    FETCH_CACHE_CAP = 8

    def fetch(self, path: str, *, broadcast: bool = False):
        blob = self.board.get(path, reader=self.client_id)
        if blob is None:
            return None
        return self._open(blob, broadcast=broadcast)

    def fetch_cached(self, path: str, *, broadcast: bool = False):
        """Conditional fetch: re-download only when the resource's
        overwrite version moved past what this client last saw (HTTP
        ETag / If-None-Match shape). Clients poll ``runs/<rid>/status``
        and the async global every tick; those resources change once
        per round at most, so the unchanged ticks collapse to a
        metadata-only round trip and the cached plaintext is reused."""
        seen_version, cached = self._fetch_cache.get(path, (0, None))
        blob, version = self.board.get_if_newer(path, seen_version,
                                                reader=self.client_id)
        if blob is None:
            if version == 0:               # resource gone (or never there)
                self._fetch_cache.pop(path, None)
                return None
            if version < seen_version:     # deleted + re-published: refetch
                self._fetch_cache.pop(path, None)
                return self.fetch_cached(path, broadcast=broadcast)
            return cached                  # 304: unchanged since last look
        payload = self._open(blob, broadcast=broadcast)
        self._fetch_cache[path] = (version, payload)
        while len(self._fetch_cache) > self.FETCH_CACHE_CAP:
            self._fetch_cache.pop(next(iter(self._fetch_cache)))
        return payload

    def _open(self, blob: bytes, *, broadcast: bool):
        key = self.broadcast_key if broadcast else self.channel_key
        body = serialization.unpack(crypto.decrypt(key, blob))
        # server authentication (§VII): verify certificate before trusting
        if self.ca_key is not None:
            if not crypto.verify_certificate(body["server_id"], body["cert"],
                                             self.ca_key):
                raise ValueError("server certificate verification failed")
        return body["payload"]

    def poll(self, path: str, *, broadcast: bool = False, timeout: float = 0.0,
             interval: float = 0.01):
        """Pull-based wait for a resource to appear."""
        deadline = time.time() + timeout
        while True:
            got = self.fetch(path, broadcast=broadcast)
            if got is not None or time.time() >= deadline:
                return got
            time.sleep(interval)

    def post(self, path: str, payload):
        blob = crypto.encrypt(self.channel_key, serialization.pack(payload))
        self.board.put_client(self.client_id, self.token, path, blob)

    def heartbeat(self, run_id: str, n: int):
        """Post/refresh this client's liveness heartbeat for ``run_id``.

        The refresh itself is the signal: each overwrite bumps the
        resource's board-side version, which the server reads via
        ``board.stat`` to distinguish *slow* (still refreshing) from
        *gone* (frozen) when a round deadline expires. The board holds
        exactly one heartbeat per client per run; the encrypted counter
        payload is informational only."""
        self.post(f"runs/{run_id}/heartbeat/{self.client_id}", {"n": int(n)})
