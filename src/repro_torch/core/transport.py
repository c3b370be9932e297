"""Transport layer: the message board's storage substrate, pluggable.

The paper's Communicator (§V/§VI) is a REST resource board silos poll
over a real WAN; ``MessageBoard`` used to *be* its in-process stand-in —
one dict, one class. This module splits the board into layers
(DESIGN.md §Transport layer):

* ``Transport`` — the storage interface: ``put``/``get``/``stat``/
  ``stat_many``/``list``/``delete``/``latest_seq`` over opaque resource
  blobs, plus the board-wide monotonic mutation counter ``seq``. A
  transport stores ciphertext and resource metadata; it knows nothing
  about tokens, provenance, tombstones or round semantics — that policy
  stays in ``MessageBoard`` (communicator.py), which works over
  whichever backend it is given.
* ``InProcTransport`` — the dict backend, now with a directory-prefix
  index so ``list`` no longer fnmatch-scans every resource on the board
  per call (the scheduler GC and bench sweeps pattern-probe constantly).
* ``SocketTransport`` / ``SocketTransportServer`` — a multiprocess
  backend: the resource store lives in its own process behind a local
  TCP socket speaking length-prefixed msgpack frames, one request per
  frame. This is the REST-deployment shape of the paper with the HTTP
  swapped for a socket: the coordinator process holds only policy,
  every byte of resource state crosses a real process boundary. Both
  backends pass one shared conformance suite (tests/test_transport.py).
* ``WanModel`` — a deterministic inter-silo WAN cost model (per-pair
  latency + bandwidth, no wall-clock anywhere): transports consult it
  to charge *simulated* transfer time per resource moved, so benches
  can report round wall-clock in which the compressed data plane's
  4–8x wire reductions actually show up as time (Huang et al. name WAN
  latency/bandwidth heterogeneity as the dominant cross-silo cost; an
  in-process dict charges none of it).

Batched ops are the point of the interface: ``stat_many`` answers a
whole cohort sweep in one call (one RPC round-trip on the socket
backend, one lock acquisition in-proc), where the pre-refactor scheduler
stat-probed path by path.
"""
from __future__ import annotations

import hashlib
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import msgpack

_GLOB_SPECIALS = "*?["


@dataclass
class Resource:
    path: str
    blob: bytes                  # encrypted payload (opaque to the board)
    author: str                  # "server" or client_id
    created_at: float = field(default_factory=time.time)
    version: int = 1             # bumps on overwrite — monotonic, no clock
    seq: int = 0                 # board-wide mutation counter at last write


def _meta(r: Resource) -> dict:
    return {"author": r.author, "created_at": r.created_at,
            "version": r.version, "bytes": len(r.blob), "seq": r.seq}


# ---------------------------------------------------------------------------
# WAN cost model
# ---------------------------------------------------------------------------
class WanModel:
    """Deterministic inter-silo WAN: per-pair latency + bandwidth.

    Every actor (silo id or ``"server"``) gets a *stable* access-link
    profile — latency and bandwidth drawn from ``seed`` and the actor
    name alone, so twin runs charge identical simulated time with no
    wall-clock involved anywhere. A transfer between two actors pays the
    sum of both access latencies and rides the narrower of the two
    links; explicit per-pair overrides (``set_link``) model dedicated
    peerings. The model also keeps the *simulated clocks*: each charge
    advances the paying actor's clock, and ``elapsed()`` — the maximum
    over actors — approximates critical-path wall-clock for a round in
    which silos transfer in parallel.

    The server profile is fat and near-instant by default: the board is
    co-located with the coordinator (the paper's REST server), so
    server-side ops are LAN, not WAN.
    """

    def __init__(self, *, seed: int = 0,
                 latency_range: Tuple[float, float] = (0.01, 0.10),
                 bandwidth_range: Tuple[float, float] = (50e6, 1e9),
                 server_latency: float = 5e-4,
                 server_bandwidth: float = 10e9):
        self.seed = int(seed)
        self.latency_range = latency_range
        self.bandwidth_range = bandwidth_range
        self.server_latency = float(server_latency)
        self.server_bandwidth = float(server_bandwidth)
        self._links: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self.clocks: Dict[str, float] = {}
        self.charges = 0

    # --- link parameters (pure, deterministic) -------------------------
    def _u(self, tag: str) -> float:
        """Uniform [0, 1) drawn from (seed, tag) — stable across runs."""
        h = hashlib.sha256(f"wan/{self.seed}/{tag}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64

    def profile(self, actor: str) -> Tuple[float, float]:
        """(access latency s, access bandwidth bit/s) of one actor."""
        if actor == "server":
            return (self.server_latency, self.server_bandwidth)
        lo, hi = self.latency_range
        lat = lo + (hi - lo) * self._u(f"lat/{actor}")
        blo, bhi = self.bandwidth_range
        bw = blo + (bhi - blo) * self._u(f"bw/{actor}")
        return (lat, bw)

    def set_link(self, a: str, b: str, latency_s: float,
                 bandwidth_bps: float):
        """Dedicated peering override for the unordered pair {a, b}."""
        key = (min(a, b), max(a, b))
        self._links[key] = (float(latency_s), float(bandwidth_bps))

    def link(self, src: str, dst: str) -> Tuple[float, float]:
        key = (min(src, dst), max(src, dst))
        if key in self._links:
            return self._links[key]
        lat_s, bw_s = self.profile(src)
        lat_d, bw_d = self.profile(dst)
        return (lat_s + lat_d, min(bw_s, bw_d))

    def transfer_time(self, src: str, dst: str, nbytes: int) -> float:
        lat, bw = self.link(src, dst)
        return lat + 8.0 * nbytes / bw

    def rtt(self, src: str, dst: str) -> float:
        lat, _ = self.link(src, dst)
        return 2.0 * lat

    # --- simulated clocks ----------------------------------------------
    def charge(self, actor: str, seconds: float) -> float:
        self.clocks[actor] = self.clocks.get(actor, 0.0) + float(seconds)
        self.charges += 1
        return self.clocks[actor]

    def charge_transfer(self, src: str, dst: str, nbytes: int, *,
                        actor: Optional[str] = None) -> float:
        """Charge a resource transfer to ``actor`` (default: whichever
        endpoint is not the server — the silo pays its own WAN time)."""
        if actor is None:
            actor = src if dst == "server" else dst
        return self.charge(actor, self.transfer_time(src, dst, nbytes))

    def charge_rtt(self, src: str, dst: str, *,
                   actor: Optional[str] = None) -> float:
        """Charge a metadata-only round trip (a poll that found nothing,
        a conditional fetch answered 304-style)."""
        if actor is None:
            actor = src if dst == "server" else dst
        return self.charge(actor, self.rtt(src, dst))

    def elapsed(self) -> float:
        """Critical-path approximation: the busiest actor's clock."""
        return max(self.clocks.values()) if self.clocks else 0.0

    def reset(self):
        self.clocks.clear()
        self.charges = 0


# ---------------------------------------------------------------------------
# Transport interface
# ---------------------------------------------------------------------------
class Transport:
    """Storage substrate the MessageBoard policy shell runs over.

    Implementations MUST provide identical observable semantics (the
    conformance suite in tests/test_transport.py runs against each):

    * ``put`` overwrites in place, bumping ``version`` (per path) and
      ``seq`` (board-wide). Deletion removes the record entirely, so a
      re-put starts fresh at version 1 — the board's tombstones, not
      the transport, carry deletion history across a path's lifetimes.
    * ``stat``/``stat_many`` return metadata without the blob
      (``author``/``created_at``/``version``/``bytes``/``seq``).
    * ``list`` returns the sorted paths matching an ``fnmatchcase``
      pattern, byte-exact on every platform.
    * ``delete`` returns the deletion's mutation seq (``None`` if the
      path did not exist) — the board shell records it as a tombstone.
    * ``latest_seq`` is the max ``seq`` among the named *live* paths.

    ``wan``: optional ``WanModel`` consulted to charge simulated
    transfer time for every resource that crosses the (modelled or
    real) process boundary. Charged transport-side so every backend
    prices the same ops the same way.
    """

    wan: Optional[WanModel] = None

    def put(self, path: str, blob: bytes, author: str) -> dict:
        """Store/overwrite; returns the new resource metadata."""
        raise NotImplementedError

    def get(self, path: str, *, reader: str = "server") -> Optional[bytes]:
        raise NotImplementedError

    def get_if_newer(self, path: str, version: int, *,
                     reader: str = "server"
                     ) -> Tuple[Optional[bytes], int]:
        """Conditional fetch (HTTP ETag / If-None-Match shape): returns
        ``(blob, version)`` when the stored version is newer than
        ``version``, else ``(None, stored_version)`` — a metadata-only
        round trip (``0`` when the path is absent). Lets pollers skip
        re-downloading an unchanged resource every tick."""
        raise NotImplementedError

    def stat(self, path: str) -> Optional[dict]:
        raise NotImplementedError

    def stat_many(self, paths: List[str]) -> Dict[str, Optional[dict]]:
        """One batched metadata sweep — single round trip / lock hold."""
        raise NotImplementedError

    def list(self, pattern: str) -> List[str]:
        raise NotImplementedError

    def delete(self, path: str) -> Optional[int]:
        raise NotImplementedError

    def latest_seq(self, paths) -> int:
        raise NotImplementedError

    @property
    def seq(self) -> int:
        raise NotImplementedError

    def close(self):
        """Release backend resources (sockets, processes). Idempotent."""

    # --- shared WAN charging hooks -------------------------------------
    def _charge_up(self, author: str, nbytes: int):
        if self.wan is not None and author != "server":
            self.wan.charge_transfer(author, "server", nbytes)

    def _charge_down(self, reader: str, nbytes: Optional[int]):
        """A fetch: full transfer when a blob moved, one RTT when the
        poll came back empty/unchanged (the request still crossed the
        WAN). Server-side reads are board-local: free."""
        if self.wan is None or reader in (None, "server"):
            return
        if nbytes:
            self.wan.charge_transfer("server", reader, nbytes)
        else:
            self.wan.charge_rtt("server", reader)


def _pattern_prefix_dir(pattern: str) -> Optional[str]:
    """Static directory prefix of a glob pattern: everything up to the
    last ``/`` before the first fnmatch special character. ``None`` when
    the pattern has no special characters before any ``/`` (no usable
    prefix) — callers fall back to the full scan."""
    cut = len(pattern)
    for ch in _GLOB_SPECIALS:
        i = pattern.find(ch)
        if i != -1:
            cut = min(cut, i)
    if cut == len(pattern):
        return None                       # no specials: exact-path lookup
    slash = pattern.rfind("/", 0, cut)
    if slash <= 0:
        return None                       # wildcard in the first segment
    return pattern[:slash]


class InProcTransport(Transport):
    """The in-process dict backend, with a directory index for ``list``.

    ``_dirs`` maps every ancestor directory of a stored path to the set
    of full paths beneath it, so a pattern probe like
    ``runs/<rid>/round/3/update/*`` touches only that run's resources —
    the pre-refactor board fnmatch-scanned *every* resource on the board
    per call, O(total) per probe, per tick, per job. Glob semantics are
    unchanged (candidates are still filtered through ``fnmatchcase``;
    the index only prunes what the scan would have rejected anyway —
    a matching path must start with the pattern's static prefix).
    """

    def __init__(self, wan: Optional[WanModel] = None):
        self.wan = wan
        self._resources: Dict[str, Resource] = {}
        self._dirs: Dict[str, set] = {}
        self._seq = 0
        self._lock = threading.RLock()
        self.list_index_hits = 0          # fast-path probes (regression
        self.list_full_scans = 0          # tests + bench accounting)

    # --- index maintenance ---------------------------------------------
    @staticmethod
    def _ancestors(path: str):
        i = path.find("/")
        while i != -1:
            yield path[:i]
            i = path.find("/", i + 1)

    def _index_add(self, path: str):
        for d in self._ancestors(path):
            self._dirs.setdefault(d, set()).add(path)

    def _index_remove(self, path: str):
        for d in self._ancestors(path):
            bucket = self._dirs.get(d)
            if bucket is not None:
                bucket.discard(path)
                if not bucket:
                    del self._dirs[d]

    # --- Transport -----------------------------------------------------
    def put(self, path: str, blob: bytes, author: str) -> dict:
        with self._lock:
            prev = self._resources.get(path)
            self._seq += 1
            if prev is None:
                self._index_add(path)
            self._resources[path] = r = Resource(
                path, blob, author,
                version=prev.version + 1 if prev else 1, seq=self._seq)
            self._charge_up(author, len(blob))
            return _meta(r)

    def get(self, path: str, *, reader: str = "server") -> Optional[bytes]:
        with self._lock:
            r = self._resources.get(path)
            self._charge_down(reader, len(r.blob) if r else None)
            return r.blob if r else None

    def get_if_newer(self, path: str, version: int, *,
                     reader: str = "server"):
        with self._lock:
            r = self._resources.get(path)
            if r is None:
                self._charge_down(reader, None)
                return (None, 0)
            if r.version <= version:
                self._charge_down(reader, None)   # 304: metadata-only RTT
                return (None, r.version)
            self._charge_down(reader, len(r.blob))
            return (r.blob, r.version)

    def stat(self, path: str) -> Optional[dict]:
        with self._lock:
            r = self._resources.get(path)
            return _meta(r) if r else None

    def stat_many(self, paths) -> Dict[str, Optional[dict]]:
        with self._lock:
            out = {}
            for p in paths:
                r = self._resources.get(p)
                out[p] = _meta(r) if r else None
            return out

    def list(self, pattern: str) -> List[str]:
        import fnmatch
        with self._lock:
            if not any(ch in pattern for ch in _GLOB_SPECIALS):
                # no glob at all: exact membership, O(1)
                self.list_index_hits += 1
                return [pattern] if pattern in self._resources else []
            prefix = _pattern_prefix_dir(pattern)
            if prefix is not None:
                self.list_index_hits += 1
                candidates = self._dirs.get(prefix, ())
            else:
                self.list_full_scans += 1
                candidates = self._resources
            return sorted(p for p in candidates
                          if fnmatch.fnmatchcase(p, pattern))

    def delete(self, path: str) -> Optional[int]:
        with self._lock:
            if self._resources.pop(path, None) is None:
                return None
            self._index_remove(path)
            self._seq += 1
            return self._seq

    def latest_seq(self, paths) -> int:
        with self._lock:
            latest = 0
            for p in paths:
                r = self._resources.get(p)
                if r is not None and r.seq > latest:
                    latest = r.seq
            return latest

    @property
    def seq(self) -> int:
        return self._seq


# ---------------------------------------------------------------------------
# Socket backend: length-prefixed msgpack frames over a local socket
# ---------------------------------------------------------------------------
_HDR = struct.Struct(">I")


def _send_frame(sock: socket.socket, payload) -> None:
    body = msgpack.packb(payload, use_bin_type=True)
    sock.sendall(_HDR.pack(len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("transport peer closed the connection")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket):
    (length,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return msgpack.unpackb(_recv_exact(sock, length), raw=False,
                           strict_map_key=False)


def _serve_board(listener: socket.socket):
    """Board-hosting process: an InProcTransport behind an accept loop.

    One handler thread per connection; a store-wide lock makes each
    request atomic (``seq`` must be a strict total order even under
    concurrent writers on separate connections)."""
    store = InProcTransport()
    lock = threading.Lock()

    def handle(conn: socket.socket):
        try:
            while True:
                req = _recv_frame(conn)
                op, args = req[0], req[1:]
                try:
                    with lock:
                        if op == "put":
                            result = store.put(args[0], args[1], args[2])
                        elif op == "get":
                            result = store.get(args[0])
                        elif op == "get_if_newer":
                            result = list(store.get_if_newer(args[0],
                                                             args[1]))
                        elif op == "stat":
                            result = store.stat(args[0])
                        elif op == "stat_many":
                            result = store.stat_many(args[0])
                        elif op == "list":
                            result = store.list(args[0])
                        elif op == "delete":
                            result = store.delete(args[0])
                        elif op == "latest_seq":
                            result = store.latest_seq(args[0])
                        elif op == "seq":
                            result = store.seq
                        elif op == "ping":
                            result = "pong"
                        else:
                            raise ValueError(f"unknown op {op!r}")
                    _send_frame(conn, {"ok": result})
                except Exception as exc:  # answer, don't kill the server
                    _send_frame(conn, {"err": f"{type(exc).__name__}: "
                                              f"{exc}"})
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    try:
        while True:
            conn, _ = listener.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=handle, args=(conn,),
                             daemon=True).start()
    except OSError:
        pass                               # listener closed: shut down


def _serve_main(host: str = "127.0.0.1"):  # child-process entry point
    listener = socket.socket()
    listener.bind((host, 0))
    listener.listen(64)
    import sys as _sys
    print(listener.getsockname()[1], flush=True)
    _sys.stdout.close()                   # the port is the whole handshake
    _serve_board(listener)


class SocketTransportServer:
    """Hosts the resource store in its own process.

    ``start()`` launches a fresh interpreter (plain ``subprocess``, NOT
    ``multiprocessing``: fork would duplicate the driver's live XLA
    threads, and the spawn/forkserver methods re-import ``__main__``,
    which explodes in unguarded scripts/REPLs) that binds
    ``127.0.0.1:<ephemeral>``, prints the port on stdout and serves
    forever; ``stop()`` terminates it. ``in_process=True`` runs the
    accept loop in a daemon thread instead — same wire protocol, no
    subprocess — for tests that want the frame layer without the
    process boundary."""

    def __init__(self, host: str = "127.0.0.1"):
        self.host = host
        self.port: Optional[int] = None
        self._proc = None
        self._listener: Optional[socket.socket] = None

    def start(self, *, in_process: bool = False) -> Tuple[str, int]:
        if self.port is not None:
            return (self.host, self.port)
        if in_process:
            self._listener = socket.socket()
            self._listener.bind((self.host, 0))
            self._listener.listen(64)
            self.port = self._listener.getsockname()[1]
            threading.Thread(target=_serve_board, args=(self._listener,),
                             daemon=True).start()
            return (self.host, self.port)
        import os
        import subprocess
        import sys
        env = dict(os.environ)
        # the child needs this package importable no matter how the
        # parent arranged sys.path (pytest, bench scripts, REPL)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        self._proc = subprocess.Popen(
            [sys.executable, "-c",
             "from repro_torch.core.transport import _serve_main; "
             f"_serve_main({self.host!r})"],
            stdout=subprocess.PIPE, env=env)
        line = self._proc.stdout.readline().strip()
        if not line:
            self._proc.terminate()
            raise RuntimeError("board-hosting process failed to start")
        self.port = int(line)
        return (self.host, self.port)

    def stop(self):
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except Exception:
                self._proc.kill()
            self._proc = None
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        self.port = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class SocketTransport(Transport):
    """Client half of the socket backend: one framed request per op.

    Batched calls (``stat_many``, ``latest_seq``) are the reason the
    interface has them: a cohort sweep is ONE round trip here, where
    per-path probing would pay one per member per tick. Thread-safe (a
    lock serializes frames on the single connection)."""

    def __init__(self, address: Tuple[str, int],
                 wan: Optional[WanModel] = None):
        self.address = tuple(address)
        self.wan = wan
        self._sock = socket.create_connection(self.address)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self.round_trips = 0

    def _call(self, op: str, *args):
        with self._lock:
            _send_frame(self._sock, [op, *args])
            resp = _recv_frame(self._sock)
            self.round_trips += 1
        if "err" in resp:
            raise RuntimeError(f"transport error for {op}: {resp['err']}")
        return resp["ok"]

    def put(self, path: str, blob: bytes, author: str) -> dict:
        meta = self._call("put", path, bytes(blob), author)
        self._charge_up(author, len(blob))
        return meta

    def get(self, path: str, *, reader: str = "server") -> Optional[bytes]:
        blob = self._call("get", path)
        self._charge_down(reader, len(blob) if blob is not None else None)
        return blob

    def get_if_newer(self, path: str, version: int, *,
                     reader: str = "server"):
        blob, ver = self._call("get_if_newer", path, int(version))
        self._charge_down(reader, len(blob) if blob is not None else None)
        return (blob, int(ver))

    def stat(self, path: str) -> Optional[dict]:
        return self._call("stat", path)

    def stat_many(self, paths) -> Dict[str, Optional[dict]]:
        paths = list(paths)
        if not paths:
            return {}
        return self._call("stat_many", paths)

    def list(self, pattern: str) -> List[str]:
        return self._call("list", pattern)

    def delete(self, path: str) -> Optional[int]:
        return self._call("delete", path)

    def latest_seq(self, paths) -> int:
        paths = list(paths)
        if not paths:
            return 0
        return int(self._call("latest_seq", paths))

    @property
    def seq(self) -> int:
        return int(self._call("seq"))

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


def make_transport(kind: str = "inproc", *,
                   wan: Optional[WanModel] = None):
    """Factory for drivers/benches: returns ``(transport, closer)``.

    ``kind``: ``"inproc"`` (dict backend, no extra process) or
    ``"socket"`` (spawns a board-hosting subprocess; ``closer()`` tears
    both the connection and the process down)."""
    if kind == "inproc":
        t = InProcTransport(wan=wan)
        return t, t.close
    if kind == "socket":
        server = SocketTransportServer()
        server.start()
        t = SocketTransport((server.host, server.port), wan=wan)

        def closer():
            t.close()
            server.stop()
        return t, closer
    raise ValueError(f"unknown transport kind {kind!r}; "
                     f"known: inproc, socket")
