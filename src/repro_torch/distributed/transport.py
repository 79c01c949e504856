"""Real heartbeat transports feeding ``ElasticConfig.step_feed``.

The elastic policy (:mod:`repro_torch.distributed.elastic`) is pure: the
:class:`HeartbeatMonitor` consumes ``{rank: (step, step_time)}`` events and
never cares where they came from.  Tests inject fakes; a real fleet needs a
transport.  Two are provided, sharing one contract:

- ``emit(rank, step, step_time=None)`` — worker side, called once per train
  step (the engine's health callback drives it via ``ElasticConfig.emitter``);
- ``step_feed(global_step, world) -> {rank: (step, step_time)}`` — monitor
  side, plug-compatible with ``ElasticConfig.step_feed``.  Only ranks that
  reported IN SINCE THE LAST POLL are returned: a dead worker's stale beat
  must not keep refreshing ``WorkerView.last_seen`` or the monitor could
  never time it out;
- ``snapshot() -> {rank: {"step", "age"}}`` — last-known beat per rank with
  its wall-clock age, for post-mortem attribution (a survivor that caught a
  collective failure asks the transport *who* went silent);
- ``close()``.

:class:`FileHeartbeatTransport` — same-host multi-process.  Each beat is an
atomic ``os.replace`` of ``hb_<rank>.json`` in a shared directory; every
process can both emit and poll, so all survivors of a worker loss reach the
same verdict from the same files.

:class:`TcpHeartbeatCollector` / :class:`TcpHeartbeatEmitter` — cross-host.
A collector accepts newline-delimited JSON beats over TCP; emitters
reconnect on failure, so a rebooted worker resumes announcing itself —
which is exactly the signal the GROW planner waits for.

The TCP path is no longer single-decider.  A ``tcp://a:p,b:p,...`` spec is
an ordered FAILOVER LIST in leader-succession order: address ``k`` is the
collector candidate on the host owning rank ``k``.  Each serving collector
*peer-mirrors*: every beat it accepts first-hand (a socket delivery or its
own local ``emit``) is replicated — tagged ``fwd`` so replicas are never
re-replicated — to the other collectors, so the standbys on the
next-lowest ranks hold the same beat table as the primary.  Emitters dial
the first reachable address and fail over down the list, so when the
primary's host dies its beats land on the standby that is about to become
the leader — a fully-primed successor (see
:mod:`repro_torch.distributed.leader`).

Beats carry a per-emitter monotonically increasing ``seq`` so "reported in
since the last poll" is well-defined even when the step counter repeats
(e.g. a worker that restarts and re-announces step 0).

The standard library only; the JAX package's ``repro.distributed.transport``
call for call, so each package reads the other's beats.
"""
from __future__ import annotations

import json
import os
import queue
import socket
import tempfile
import threading
import time


def _beat(rank: int, step: int, step_time: float | None, seq: int) -> dict:
    return {"rank": int(rank), "step": int(step), "step_time": step_time,
            "seq": int(seq), "wall": time.time()}


class FileHeartbeatTransport:
    """Heartbeats as atomic per-rank JSON files in a shared directory."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._seq: dict[int, int] = {}        # emitter side, per local rank
        # Monitor side: prime the poll baseline with whatever beat files
        # already exist, so they are NOT reported as fresh on the first
        # poll.  A relaunched trainer reuses the shared directory, and a
        # dead worker's stale file must not read as that worker "returning"
        # — only a beat emitted AFTER this transport was built counts.
        self._last_polled: dict[int, int] = {
            rank: b["seq"] for rank, b in self._read_all().items()}

    # -------------------------------------------------------------- emit side
    def emit(self, rank: int, step: int, step_time: float | None = None) -> None:
        seq = self._seq.get(rank, 0) + 1
        self._seq[rank] = seq
        fd, tmp = tempfile.mkstemp(prefix=f".hb_{rank}-", dir=self.dir)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(_beat(rank, step, step_time, seq), f)
            os.replace(tmp, os.path.join(self.dir, f"hb_{rank}.json"))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # ----------------------------------------------------------- monitor side
    def _read_all(self) -> dict[int, dict]:
        beats = {}
        for name in os.listdir(self.dir):
            if not (name.startswith("hb_") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.dir, name)) as f:
                    b = json.load(f)
                beats[int(b["rank"])] = b
            except (OSError, ValueError, KeyError):
                continue  # mid-replace or torn write: catch it next poll
        return beats

    def step_feed(self, global_step: int, world: int) -> dict:
        """Ranks whose beat advanced since the last poll (ElasticConfig
        contract).  Includes ranks OUTSIDE [0, world) — returned workers
        announcing themselves, which the engine turns into a grow plan."""
        out = {}
        for rank, b in self._read_all().items():
            if b["seq"] != self._last_polled.get(rank):
                self._last_polled[rank] = b["seq"]
                out[rank] = (b["step"], b.get("step_time"))
        return out

    def snapshot(self) -> dict[int, dict]:
        now = time.time()
        return {rank: {"step": b["step"], "age": now - b["wall"]}
                for rank, b in self._read_all().items()}

    def close(self) -> None:
        pass


class TcpHeartbeatCollector:
    """Monitor half of the TCP transport: accepts beats, answers polls.

    Binds immediately (``port=0`` picks a free one — read ``.port``); a
    daemon thread accepts connections and one reader thread per emitter
    drains newline-delimited JSON beats into the latest-beat table.  The
    collector can also ``emit`` for its own local ranks directly — the
    collector's host is a worker too and should not dial itself.

    ``mirrors``: peer collector addresses (the REST of the failover list).
    Every first-hand beat — delivered on a socket without the ``fwd`` tag,
    or emitted locally — is replicated to them fire-and-forget, so a
    standby collector holds the same beat table as the primary and a
    leader-succession takeover starts from primed ``snapshot()`` /
    ``step_feed()`` state instead of a blank one.  Forwarded beats are
    stored but never re-forwarded (no mirror loops), and each collector
    re-stamps its own ``seq``, so the since-last-poll contract holds
    per-collector no matter which peer a beat arrived through.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 *, mirrors: tuple[str, ...] | list[str] = ()):
        self._lock = threading.Lock()
        self._beats: dict[int, dict] = {}
        self._last_polled: dict[int, int] = {}
        self._seq = 0
        self._closed = False
        self._conns: set[socket.socket] = set()
        self._mirrors = [TcpHeartbeatEmitter(a) for a in mirrors]
        # Replication runs on ONE dedicated pump thread fed by a bounded
        # queue: _store is called from the training loop (local emit) and
        # from every per-connection drain thread, and a dial to a dead or
        # partitioned mirror costs up to connect_timeout — paying that in
        # the step loop would throttle training, and concurrent send()s on
        # one mirror socket would race/interleave.  A full queue drops the
        # beat, like every other emit path: silence is the signal.
        self._mirror_q: queue.Queue | None = None
        if self._mirrors:
            self._mirror_q = queue.Queue(maxsize=1024)
            threading.Thread(target=self._mirror_pump, daemon=True).start()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen()
        self.host, self.port = self._srv.getsockname()[:2]
        self.address = f"{self.host}:{self.port}"
        self._acceptor = threading.Thread(target=self._accept_loop, daemon=True)
        self._acceptor.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # socket closed
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._drain, args=(conn,),
                             daemon=True).start()

    def _drain(self, conn: socket.socket) -> None:
        buf = b""
        try:
            with conn:
                while True:
                    try:
                        chunk = conn.recv(4096)
                    except OSError:
                        return
                    if not chunk:
                        return
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        try:
                            b = json.loads(line)
                            self._store(int(b["rank"]), int(b["step"]),
                                        b.get("step_time"),
                                        forwarded=bool(b.get("fwd")))
                        except (ValueError, KeyError, TypeError):
                            continue
        finally:
            with self._lock:
                self._conns.discard(conn)

    def _store(self, rank: int, step: int, step_time: float | None,
               *, forwarded: bool = False) -> None:
        with self._lock:
            self._seq += 1
            self._beats[rank] = _beat(rank, step, step_time, self._seq)
        if forwarded or self._mirror_q is None:
            return
        # Replicate first-hand beats to the standby collectors via the pump
        # thread, fire-and-forget: a dead mirror is a dead HOST, and the
        # surviving collectors keep working without it.
        try:
            self._mirror_q.put_nowait({"rank": rank, "step": step,
                                       "step_time": step_time, "fwd": True})
        except queue.Full:
            pass

    def _mirror_pump(self) -> None:
        while not self._closed:
            try:
                payload = self._mirror_q.get(timeout=0.5)
            except queue.Empty:
                continue
            for m in self._mirrors:
                m.send(payload)

    # ------------------------------------------------------ transport contract
    def emit(self, rank: int, step: int, step_time: float | None = None) -> None:
        self._store(rank, step, step_time)

    def step_feed(self, global_step: int, world: int) -> dict:
        out = {}
        with self._lock:
            for rank, b in self._beats.items():
                if b["seq"] != self._last_polled.get(rank):
                    self._last_polled[rank] = b["seq"]
                    out[rank] = (b["step"], b.get("step_time"))
        return out

    def snapshot(self) -> dict[int, dict]:
        now = time.time()
        with self._lock:
            return {rank: {"step": b["step"], "age": now - b["wall"]}
                    for rank, b in self._beats.items()}

    def close(self) -> None:
        self._closed = True
        # shutdown() BEFORE close(): the acceptor thread is blocked inside
        # accept(), which holds the kernel's open file description — a bare
        # close() leaves the socket LISTENing forever and the port can
        # never be re-bound by a restarted or successor collector.
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # ENOTCONN on some platforms: the close below suffices
        try:
            self._srv.close()
        except OSError:
            pass
        # Close accepted connections too, or their drain threads would keep
        # the local port busy and a RESTARTED collector (or the successor
        # re-binding a failover address) could never re-bind it.
        with self._lock:
            conns, self._conns = set(self._conns), set()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for m in self._mirrors:
            m.close()


class TcpHeartbeatEmitter:
    """Worker half of the TCP transport.  Beats are fire-and-forget: a send
    failure drops the beat and retries the connection on a later one —
    silence IS the failure signal, so the emitter must never take the
    training loop down with it.  After a failed dial the emitter backs off
    (``retry_after`` seconds) before dialling again: against a PARTITIONED
    collector (SYNs silently dropped) every connection attempt costs the
    full ``connect_timeout``, and paying that inside the step loop on every
    step would throttle training indefinitely.

    ``addresses`` may be an ordered FAILOVER list (or one ``host:port``
    string): the emitter dials the first reachable address, sticks to it,
    and on a lost connection resumes the search FROM that address down the
    list (wrapping) — so when the primary collector's host dies, beats
    land on the standby collector next in the leader-succession order.
    Only a full fruitless sweep of the list arms the backoff; a failed
    send on an established socket still gets its immediate re-dial."""

    def __init__(self, addresses: str | list[str] | tuple[str, ...], *,
                 connect_timeout: float = 2.0, retry_after: float = 5.0):
        if isinstance(addresses, str):
            addresses = [a for a in addresses.split(",") if a]
        if not addresses:
            raise ValueError("TcpHeartbeatEmitter needs at least one address")
        self._addrs = [(h, int(p))
                       for h, p in (a.rsplit(":", 1) for a in addresses)]
        self._i = 0  # index of the address the current/last socket dialled
        self._sock: socket.socket | None = None
        self._connect_timeout = connect_timeout
        self._retry_after = retry_after
        self._next_dial = 0.0
        # Serialises send(): the socket teardown-on-error races any second
        # caller, and interleaved partial sendall()s would tear JSON lines.
        self._send_lock = threading.Lock()

    def emit(self, rank: int, step: int, step_time: float | None = None) -> None:
        self.send({"rank": int(rank), "step": int(step),
                   "step_time": step_time})

    def send(self, payload: dict) -> None:
        """Fire-and-forget one JSON line (the collector mirrors ride this
        too, with their ``fwd``-tagged payloads)."""
        line = (json.dumps(payload) + "\n").encode()
        with self._send_lock:
            for _ in range(2):  # current socket, then one fresh dial sweep
                if self._sock is None and not self._dial():
                    return  # all addresses down or backing off: drop it
                try:
                    self._sock.sendall(line)
                    return
                except OSError:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None

    def _dial(self) -> bool:
        """One failover sweep: current address first, then down the list.
        The per-address timeout divides by the list length so a fully
        partitioned sweep costs ~one ``connect_timeout`` total — the
        worst-case step-loop stall must not scale with the failover
        depth."""
        if time.monotonic() < self._next_dial:
            return False  # backing off: stay fast inside the step loop
        # Floored so a LONG list can't shrink the per-dial budget below
        # realistic TCP connect latency (a healthy-but-distant collector
        # must not read as down just because the succession list is deep).
        per_addr = max(self._connect_timeout / len(self._addrs), 0.5)
        for k in range(len(self._addrs)):
            j = (self._i + k) % len(self._addrs)
            try:
                self._sock = socket.create_connection(
                    self._addrs[j], timeout=per_addr)
                self._i = j
                return True
            except OSError:
                continue
        self._next_dial = time.monotonic() + self._retry_after
        return False

    def close(self) -> None:
        # Under _send_lock: a bare close() would be exactly the "second
        # caller" race the lock exists for — nulling _sock between an
        # in-flight send()'s None-check and its sendall (the collector's
        # mirror pump closes emitters another thread may be sending on).
        with self._send_lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


def tcp_addresses(spec: str) -> list[str] | None:
    """The ordered collector-candidate list of a ``tcp://`` spec (None for
    other transports).  The one parser of the failover grammar — callers
    deciding serve/serve_index (e.g. the launcher's "do I bind slot k?")
    must use this rather than re-splitting the flag themselves."""
    if not spec.startswith("tcp://"):
        return None
    return [a for a in spec[len("tcp://"):].split(",") if a]


def make_transport(spec: str, *, serve: bool = False, serve_index: int = 0):
    """Build a transport from a launcher flag.

    ``file:/shared/dir`` -> :class:`FileHeartbeatTransport` (both halves —
    the file transport is symmetric, every process can emit AND poll).

    ``tcp://a:p,b:p,...`` -> an ordered failover list in leader-succession
    order (one address per collector candidate; a single ``tcp://host:port``
    is the list of one).  With ``serve`` this process binds address
    ``serve_index`` and peer-mirrors accepted beats to every OTHER address
    (:class:`TcpHeartbeatCollector`); without it the workers dial the first
    reachable address and fail over down the list
    (:class:`TcpHeartbeatEmitter`).
    """
    if spec.startswith("file:"):
        return FileHeartbeatTransport(spec[len("file:"):])
    addrs = tcp_addresses(spec)
    if addrs is not None:
        if serve:
            if not 0 <= serve_index < len(addrs):
                raise ValueError(
                    f"serve_index {serve_index} outside the {len(addrs)}-entry "
                    f"failover list {addrs!r}")
            host, port = addrs[serve_index].rsplit(":", 1)
            mirrors = [a for i, a in enumerate(addrs) if i != serve_index]
            return TcpHeartbeatCollector(host=host, port=int(port),
                                         mirrors=mirrors)
        return TcpHeartbeatEmitter(addrs)
    raise ValueError(f"unknown heartbeat transport {spec!r}; "
                     "expected file:<dir> or tcp://<host>:<port>[,host:port...]")
