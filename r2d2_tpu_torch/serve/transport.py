"""Request/reply transports of the policy server, the JAX package's
``serve/transport.py``.

The serving plane moves small fixed-shape records, one observation frame
up and one (action, Q, hidden) down, at env-step cadence:

  * ``InprocEndpoint`` / ``InprocChannel`` — thread clients in the
    server's process: a queue of (Request, reply_fn) pairs. The endpoint
    outlives a server, so a replacement server drains the same inbox.
  * ``ShmServeTransport`` / ``ShmServeChannel`` — process clients on the
    same host: the native shared-memory MPMC ring (``native/shm_ring.cc``)
    over fixed-layout request records; each client owns a small reply
    ring whose name rides in every request.
  * ``SocketServerTransport`` / ``SocketChannel`` — clients anywhere:
    length-prefixed pickle over TCP, one connection a client process,
    replies matched by ``req_id`` so pipelined lanes may complete out of
    order.

All three deliver into one server inbox; the micro-batcher
(serve/server.py) does not know which a request came by.
"""

import pickle
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# Request kinds. STEP advances the client's server-held recurrent state
# (the local policy's ``step``); BOOTSTRAP runs the forward without
# advancing it (``bootstrap_q``); DISCONNECT releases the client's state
# slot lease (the state is kept until the lease times out, so a reconnect
# resumes mid-episode).
KIND_STEP, KIND_BOOTSTRAP, KIND_DISCONNECT = 0, 1, 2
# Reply statuses. EXPIRED: judged stale and not applied, rebuild and
# resend. MISROUTED: kept for the JAX package's wire values; a single
# server never sends it. RETRY: admission control shed the request at the
# queue-depth bound, not applied; back off ``retry_after_ms`` and resend.
STATUS_OK, STATUS_EXPIRED, STATUS_MISROUTED, STATUS_RETRY = 0, 1, 2, 3

# shm layout: a reply ring's name in a fixed char field
_REPLY_NAME_BYTES = 48


class ServeTimeout(Exception):
    """A request saw no reply inside the client timeout (server busy, dead
    or restarting): the client backs off and retries."""


class ServeUnavailable(Exception):
    """Retries exhausted (``max_retry_s``): the caller fails loudly and
    worker supervision takes over."""


@dataclass
class Request:
    """One client -> server message. ``reset_obs``/``obs`` carry the local
    policy's state changes (observe_reset / observe) on the next forward
    request, so a state change never costs a round trip."""

    client_id: int
    req_id: int
    kind: int = KIND_STEP
    t_submit: float = 0.0          # client time.monotonic (informational)
    # logical operation number, once per client step()/bootstrap() and the
    # same across retries of one operation (req_id is fresh per attempt):
    # the server replays the cached reply of an operation it applied
    # already instead of advancing the state again. -1 = no dedup.
    op_seq: int = -1
    reset_obs: Optional[np.ndarray] = None   # (H, W) uint8 episode start
    obs: Optional[np.ndarray] = None         # (H, W) uint8 pending frame
    action: int = -1                          # pending observe action
    reply_to: str = ""             # shm: the client's reply ring's name
    t_recv: float = 0.0            # server-side arrival (monotonic): the
    #                                TTL's clock


@dataclass
class Reply:
    req_id: int
    status: int = STATUS_OK
    action: int = -1
    q: Optional[np.ndarray] = None           # (A,) f32
    hidden: Optional[np.ndarray] = None      # (2, hidden) f32 post-step
    weight_version: int = 0        # the server's adopted publication
    retry_after_ms: float = 0.0    # STATUS_RETRY: suggested pause


# ---------------------------------------------------------------------------
# In-proc rung.


class _ReplyBox:
    __slots__ = ("event", "reply")

    def __init__(self):
        self.event = threading.Event()
        self.reply: Optional[Reply] = None

    def set(self, reply: Reply) -> None:
        self.reply = reply
        self.event.set()


class InprocEndpoint:
    """The server's inbox and the thread clients' rendezvous, made once and
    shared by every client channel and every server on it."""

    def __init__(self, maxsize: int = 0):
        self.inbox: "queue.Queue[Tuple[Request, Callable]]" = \
            queue.Queue(maxsize)

    def submit(self, req: Request, reply_cb: Callable[[Reply], None]) -> None:
        req.t_recv = time.monotonic()
        trace = getattr(req, "trace", None)
        if trace is not None:
            trace["t_recv_wall"] = time.time()
        self.inbox.put((req, reply_cb))

    def submit_many(self, items) -> None:
        """Submit under one lock acquisition: a batched client's lanes land
        in the inbox together, so the server's fill loop sees the whole
        tick at once."""
        now = time.monotonic()
        wall = None
        for req, _cb in items:
            req.t_recv = now
            trace = getattr(req, "trace", None)
            if trace is not None:
                if wall is None:
                    wall = time.time()
                trace["t_recv_wall"] = wall
        with self.inbox.mutex:
            self.inbox.queue.extend(items)
            self.inbox.not_empty.notify()

    def connect(self) -> "InprocChannel":
        return InprocChannel(self)


class InprocChannel:
    """Thread client channel: submit into the endpoint's queue, wait on a
    reply box per request. ``request_many`` submits every lane before
    collecting any reply, which is what fills the server's batch."""

    def __init__(self, endpoint: InprocEndpoint):
        self._ep = endpoint

    def submit(self, req: Request) -> _ReplyBox:
        box = _ReplyBox()
        self._ep.submit(req, box.set)
        return box

    def collect(self, box: _ReplyBox, timeout: float) -> Reply:
        if not box.event.wait(timeout):
            raise ServeTimeout("no reply within timeout")
        return box.reply

    def request(self, req: Request, timeout: float = 5.0) -> Reply:
        return self.collect(self.submit(req), timeout)

    def request_many(self, reqs: List[Request],
                     timeout: float = 5.0) -> Dict[int, Reply]:
        boxes = [_ReplyBox() for _ in reqs]
        self._ep.submit_many(list(zip(reqs, [b.set for b in boxes])))
        deadline = time.monotonic() + timeout
        out: Dict[int, Reply] = {}
        for r, box in zip(reqs, boxes):
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not box.event.wait(remaining):
                continue            # missing replies: the caller retries
            out[r.req_id] = box.reply
        return out

    def reconnect(self) -> None:
        """Nothing to re-dial in-process; the endpoint persists."""

    def disconnect(self, client_id: int) -> None:
        """Release the lease (fire and forget)."""
        self._ep.submit(Request(client_id=client_id, req_id=-1,
                                kind=KIND_DISCONNECT,
                                t_submit=time.monotonic()),
                        lambda _reply: None)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Socket rung: length-prefixed pickle frames.


def send_frame(sock: socket.socket, obj, lock: threading.Lock) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    with lock:
        sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def recv_frame(sock: socket.socket):
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    return pickle.loads(_recv_exact(sock, n))


class SocketServerTransport:
    """TCP listener feeding the server's inbox: one reader thread a
    connection; replies go back over the same connection under a lock per
    connection."""

    def __init__(self, submit: Callable[[Request, Callable], None],
                 host: str = "127.0.0.1", port: int = 0):
        self._submit = submit
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.25)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._conns: List[socket.socket] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="serve-accept")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            # small request/reply exchanges: Nagle plus delayed ACKs would
            # stall each one by ~40 ms
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            threading.Thread(target=self._reader_loop, args=(conn,),
                             daemon=True, name="serve-conn").start()

    def _reader_loop(self, conn: socket.socket) -> None:
        lock = threading.Lock()

        def reply_cb(reply: Reply, _conn=conn, _lock=lock):
            try:
                send_frame(_conn, reply, _lock)
            except OSError:
                pass               # the client left; its lease expires

        try:
            while not self._stop.is_set():
                self._submit(recv_frame(conn), reply_cb)
        except (ConnectionError, OSError, EOFError, pickle.PickleError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=2.0)


class SocketChannel:
    """Client channel over TCP. Dials lazily (``eager_connect``: at
    construction, so a wrong address fails where the channel is built),
    retrying ``connect_retries`` times on a backoff ladder; replies are
    matched by ``req_id`` (a stash keeps out-of-order ones). Every socket
    failure surfaces as ``ServeTimeout``, so the caller's one retry path
    covers a dead server, a restart and plain slowness."""

    def __init__(self, host: str, port: int, dial_timeout: float = 2.0,
                 connect_retries: int = 0, backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0, eager_connect: bool = False):
        self._addr = (host, port)
        self._dial_timeout = dial_timeout
        self.connect_retries = max(int(connect_retries), 0)
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._stash: Dict[int, Reply] = {}
        if eager_connect:
            self._ensure()

    def _ensure(self) -> socket.socket:
        if self._sock is None:
            attempt = 0
            while True:
                try:
                    s = socket.create_connection(
                        self._addr, timeout=self._dial_timeout)
                    break
                except OSError:
                    attempt += 1
                    if attempt > self.connect_retries:
                        raise
                    time.sleep(min(
                        self.backoff_base_s * (2 ** (attempt - 1)),
                        self.backoff_max_s))
            s.settimeout(self._dial_timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            self._stash.clear()
        return self._sock

    def _recv_until(self, req_id: int, deadline: float) -> Reply:
        while True:
            if req_id in self._stash:
                return self._stash.pop(req_id)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ServeTimeout("no reply within timeout")
            sock = self._ensure()
            sock.settimeout(remaining)
            reply = recv_frame(sock)
            if reply.req_id == req_id:
                return reply
            self._stash[reply.req_id] = reply

    def request(self, req: Request, timeout: float = 5.0) -> Reply:
        deadline = time.monotonic() + timeout
        try:
            send_frame(self._ensure(), req, self._lock)
            return self._recv_until(req.req_id, deadline)
        except (ConnectionError, OSError, EOFError, socket.timeout) as e:
            self.reconnect()
            raise ServeTimeout(str(e)) from None

    def request_many(self, reqs: List[Request],
                     timeout: float = 5.0) -> Dict[int, Reply]:
        deadline = time.monotonic() + timeout
        out: Dict[int, Reply] = {}
        try:
            sock = self._ensure()
            for r in reqs:
                send_frame(sock, r, self._lock)
            for r in reqs:
                out[r.req_id] = self._recv_until(r.req_id, deadline)
        except (ConnectionError, OSError, EOFError, socket.timeout,
                ServeTimeout):
            self.reconnect()        # partial results: the caller retries
        return out

    def reconnect(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def disconnect(self, client_id: int) -> None:
        try:
            send_frame(self._ensure(),
                       Request(client_id=client_id, req_id=-1,
                               kind=KIND_DISCONNECT,
                               t_submit=time.monotonic()), self._lock)
        except (ConnectionError, OSError):
            pass

    def close(self) -> None:
        self.reconnect()


# ---------------------------------------------------------------------------
# Shm rung: the native ring over fixed-layout request and reply records.


def request_layout(h: int, w: int,
                   tracing: bool = False) -> List[Tuple[str, tuple, np.dtype]]:
    """(field, shape, dtype) of one request slot; client and server build
    it from the same frame size. ``tracing`` appends the two wall stamps
    a traced request's hops need (0.0 = this request untraced); off, the
    layout and the slot's bytes are those of an untraced ring. Clients do
    not choose: the ring's handle carries its layout."""
    fields = [("client_id", (), np.dtype(np.int64)),
            ("req_id", (), np.dtype(np.int64)),
            ("kind", (), np.dtype(np.int64)),
            ("op_seq", (), np.dtype(np.int64)),
            ("action", (), np.dtype(np.int64)),
            ("flags", (), np.dtype(np.int64)),   # bit0 reset, bit1 observe
            ("t_submit", (), np.dtype(np.float64)),
            ("reply_to", (_REPLY_NAME_BYTES,), np.dtype(np.uint8)),
            ("reset_obs", (h, w), np.dtype(np.uint8)),
            ("obs", (h, w), np.dtype(np.uint8))]
    if tracing:
        fields += [("t_submit_wall", (), np.dtype(np.float64)),
                   ("t_send_wall", (), np.dtype(np.float64))]
    return fields


def reply_layout(action_dim: int,
                 hidden_dim: int) -> List[Tuple[str, tuple, np.dtype]]:
    return [("req_id", (), np.dtype(np.int64)),
            ("status", (), np.dtype(np.int64)),
            ("action", (), np.dtype(np.int64)),
            ("weight_version", (), np.dtype(np.int64)),
            ("q", (action_dim,), np.dtype(np.float32)),
            ("hidden", (2, hidden_dim), np.dtype(np.float32))]


@dataclass
class _Field:
    name: str
    shape: tuple
    dtype: np.dtype
    offset: int
    nbytes: int


class ShmRecordRing:
    """Fixed-record MPMC ring over the native shm ring, with the record
    layout given (``runtime/shm_feeder.py``'s block ring derives its own).
    Picklable by name: the creating side owns (and unlinks) the segment;
    an unpickled handle attaches on first use. ``untrack``: an attached
    handle leaves this process's resource tracker (False where the owner
    is a child of this process and shares its tracker)."""

    def __init__(self, layout: List[Tuple[str, tuple, np.dtype]],
                 maxsize: int = 64, _attach_name: Optional[str] = None,
                 untrack: bool = True):
        from multiprocessing import shared_memory
        self.layout = [(n, tuple(s), np.dtype(d)) for n, s, d in layout]
        self.capacity = maxsize
        self._untrack = untrack
        self._fields: List[_Field] = []
        off = 0
        for name, shape, dtype in self.layout:
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            self._fields.append(_Field(name, shape, dtype, off, nbytes))
            off += nbytes
        self.slot_bytes = off
        self._owner = _attach_name is None
        self._shm = None
        self._base = 0
        if self._owner:
            from r2d2_tpu_torch.native import ring_lib
            lib = ring_lib()
            size = int(lib.ring_required_bytes(self.capacity,
                                               self.slot_bytes))
            self._shm = shared_memory.SharedMemory(create=True, size=size)
            self._bind()
            lib.ring_init(self._base, self.capacity, self.slot_bytes)
        else:
            self._name = _attach_name

    def __getstate__(self):
        return {"layout": self.layout, "capacity": self.capacity,
                "name": self.name}

    def __setstate__(self, state):
        self.__init__(state["layout"], state["capacity"],
                      _attach_name=state["name"])

    @property
    def name(self) -> str:
        return self._shm.name if self._shm is not None else self._name

    def _bind(self) -> None:
        import ctypes
        self._cbuf = ctypes.c_char.from_buffer(self._shm.buf)
        self._base = ctypes.addressof(self._cbuf)

    def _ensure(self):
        if self._shm is None:
            from multiprocessing import shared_memory

            from r2d2_tpu_torch.runtime.weights import untrack_attached_shm
            self._shm = shared_memory.SharedMemory(name=self._name)
            if self._untrack:
                untrack_attached_shm(self._shm)
            self._bind()
        from r2d2_tpu_torch.native import ring_lib
        return ring_lib()

    def _slot_view(self, lib, pos: int) -> np.ndarray:
        off = int(lib.ring_payload_offset(self._base, pos))
        return np.ndarray((self.slot_bytes,), np.uint8, self._shm.buf, off)

    def put(self, record: Dict[str, np.ndarray],
            timeout: Optional[float] = None) -> None:
        lib = self._ensure()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            pos = int(lib.ring_reserve_push(self._base))
            if pos >= 0:
                break
            if deadline is None or time.monotonic() >= deadline:
                raise queue.Full
            time.sleep(0.0005)
        slot = self._slot_view(lib, pos)
        for f in self._fields:
            src = np.ascontiguousarray(record[f.name], f.dtype)
            slot[f.offset:f.offset + f.nbytes] = \
                src.view(np.uint8).reshape(-1)
        lib.ring_commit_push(self._base, pos)

    def get_nowait(self) -> Optional[Dict[str, np.ndarray]]:
        lib = self._ensure()
        pos = int(lib.ring_reserve_pop(self._base))
        if pos < 0:
            return None
        slot = self._slot_view(lib, pos)
        out = {}
        for f in self._fields:
            raw = slot[f.offset:f.offset + f.nbytes]
            out[f.name] = raw.view(f.dtype).reshape(f.shape).copy()
        lib.ring_commit_pop(self._base, pos)
        return out

    def qsize(self) -> int:
        lib = self._ensure()
        return int(lib.ring_size(self._base))

    def close(self) -> None:
        if self._shm is None:
            return
        self._base = 0
        self._cbuf = None
        self._shm.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
        self._shm = None


def _encode_name(name: str) -> np.ndarray:
    raw = name.encode()[:_REPLY_NAME_BYTES]
    out = np.zeros(_REPLY_NAME_BYTES, np.uint8)
    out[:len(raw)] = np.frombuffer(raw, np.uint8)
    return out


def _decode_name(arr: np.ndarray) -> str:
    raw = bytes(np.asarray(arr, np.uint8))
    return raw.rstrip(b"\x00").decode(errors="replace")


class ShmServeTransport:
    """Server side of the shm rung: owns the shared request ring, drains it
    into the inbox on a thread of its own, and puts each reply into its
    client's reply ring (attached on first use by the name in the
    request). ``clients_are_children``: the clients are processes this
    process spawned, which share its resource tracker."""

    def __init__(self, submit: Callable[[Request, Callable], None],
                 frame_hw: Tuple[int, int], action_dim: int,
                 hidden_dim: int, request_slots: int = 256,
                 clients_are_children: bool = False, tracing: bool = False):
        h, w = frame_hw
        self.request_ring = ShmRecordRing(request_layout(h, w, tracing),
                                          maxsize=request_slots)
        self._reply_layout = reply_layout(action_dim, hidden_dim)
        self._untrack = not clients_are_children
        self._submit = submit
        self._reply_rings: Dict[str, ShmRecordRing] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._drain_loop,
                                        daemon=True, name="serve-shm-drain")
        self._thread.start()

    def _reply_cb_for(self, name: str) -> Callable[[Reply], None]:
        def cb(reply: Reply, _name=name):
            ring = self._reply_rings.get(_name)
            if ring is None:
                try:
                    ring = ShmRecordRing(self._reply_layout,
                                         _attach_name=_name, maxsize=0,
                                         untrack=self._untrack)
                    ring._ensure()
                    self._reply_rings[_name] = ring
                except (OSError, FileNotFoundError):
                    return          # the client's ring is gone: drop
            try:
                ring.put({
                    "req_id": np.int64(reply.req_id),
                    "status": np.int64(reply.status),
                    "action": np.int64(reply.action),
                    "weight_version": np.int64(reply.weight_version),
                    "q": (reply.q if reply.q is not None
                          else np.zeros(self._reply_layout[4][1],
                                        np.float32)),
                    "hidden": (reply.hidden if reply.hidden is not None
                               else np.zeros(self._reply_layout[5][1],
                                             np.float32)),
                }, timeout=1.0)
            except (queue.Full, OSError):
                # a wedged or dead client must not block the server: drop
                # the reply; the client times out and retries
                self._reply_rings.pop(_name, None)
        return cb

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            try:
                rec = self.request_ring.get_nowait()
            except OSError:
                return
            if rec is None:
                time.sleep(0.0005)
                continue
            flags = int(rec["flags"])
            req = Request(
                client_id=int(rec["client_id"]), req_id=int(rec["req_id"]),
                kind=int(rec["kind"]), op_seq=int(rec["op_seq"]),
                action=int(rec["action"]),
                t_submit=float(rec["t_submit"]),
                reset_obs=rec["reset_obs"] if flags & 1 else None,
                obs=rec["obs"] if flags & 2 else None,
                reply_to=_decode_name(rec["reply_to"]))
            if "t_submit_wall" in rec and float(rec["t_submit_wall"]) > 0:
                trace = {"id": req.req_id,
                         "t_submit_wall": float(rec["t_submit_wall"])}
                if float(rec["t_send_wall"]) > 0:
                    trace["t_send_wall"] = float(rec["t_send_wall"])
                req.trace = trace
            self._submit(req, self._reply_cb_for(req.reply_to))

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self.request_ring.close()
        for ring in self._reply_rings.values():
            ring.close()
        self._reply_rings.clear()


class ShmServeChannel:
    """Client side of the shm rung: pushes requests into the server's
    request ring (the handle crossed the spawn boundary by name) and polls
    a reply ring of its own, made in the client's process so that the
    process that reads it owns and unlinks it."""

    def __init__(self, request_ring: ShmRecordRing, action_dim: int,
                 hidden_dim: int, reply_slots: int = 8):
        self._req_ring = request_ring
        self._reply_ring = ShmRecordRing(reply_layout(action_dim, hidden_dim),
                                         maxsize=reply_slots)
        self._name_field = _encode_name(self._reply_ring.name)
        self._stash: Dict[int, Reply] = {}
        self._frame_hw = next(shape for name, shape, _ in
                              self._req_ring.layout if name == "obs")
        # a traced server's ring layout has the wall-stamp fields
        self._traced_ring = any(name == "t_submit_wall"
                                for name, _, _ in self._req_ring.layout)

    def _push(self, req: Request) -> None:
        zeros = None
        flags = (1 if req.reset_obs is not None else 0) | \
                (2 if req.obs is not None else 0)
        if req.reset_obs is None or req.obs is None:
            zeros = np.zeros(self._frame_hw, np.uint8)
        record = {
            "client_id": np.int64(req.client_id),
            "req_id": np.int64(req.req_id),
            "kind": np.int64(req.kind),
            "op_seq": np.int64(req.op_seq),
            "action": np.int64(req.action),
            "flags": np.int64(flags),
            "t_submit": np.float64(req.t_submit),
            "reply_to": self._name_field,
            "reset_obs": (req.reset_obs if req.reset_obs is not None
                          else zeros),
            "obs": req.obs if req.obs is not None else zeros,
        }
        if self._traced_ring:
            trace = getattr(req, "trace", None) or {}
            record["t_submit_wall"] = np.float64(
                trace.get("t_submit_wall", 0.0))
            record["t_send_wall"] = np.float64(trace.get("t_send_wall", 0.0))
        try:
            self._req_ring.put(record, timeout=1.0)
        except queue.Full:
            raise ServeTimeout("request ring full") from None

    def _poll(self, req_id: int, deadline: float) -> Reply:
        while True:
            if req_id in self._stash:
                return self._stash.pop(req_id)
            rec = self._reply_ring.get_nowait()
            if rec is None:
                if time.monotonic() >= deadline:
                    raise ServeTimeout("no reply within timeout")
                time.sleep(0.0005)
                continue
            reply = Reply(req_id=int(rec["req_id"]),
                          status=int(rec["status"]),
                          action=int(rec["action"]),
                          q=rec["q"], hidden=rec["hidden"],
                          weight_version=int(rec["weight_version"]))
            if reply.req_id == req_id:
                return reply
            self._stash[reply.req_id] = reply

    def request(self, req: Request, timeout: float = 5.0) -> Reply:
        deadline = time.monotonic() + timeout
        self._push(req)
        return self._poll(req.req_id, deadline)

    def request_many(self, reqs: List[Request],
                     timeout: float = 5.0) -> Dict[int, Reply]:
        deadline = time.monotonic() + timeout
        out: Dict[int, Reply] = {}
        try:
            for r in reqs:
                self._push(r)
            for r in reqs:
                out[r.req_id] = self._poll(r.req_id, deadline)
        except ServeTimeout:
            pass                    # partial: the caller retries the rest
        return out

    def reconnect(self) -> None:
        """The rings outlive a server restart; only stale stashed replies
        go."""
        self._stash.clear()

    def disconnect(self, client_id: int) -> None:
        try:
            self._push(Request(client_id=client_id, req_id=-1,
                               kind=KIND_DISCONNECT,
                               t_submit=time.monotonic()))
        except ServeTimeout:
            pass

    def close(self) -> None:
        self._reply_ring.close()
