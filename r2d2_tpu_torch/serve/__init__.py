"""The central policy server, the JAX package's ``serve/`` for one server:

    transport.py   — in-proc queue, shm record rings (native/shm_ring.cc),
                     TCP sockets
    state_cache.py — per-client LSTM state, frame stack and last action,
                     with lease, evict and reconnect
    server.py      — the micro-batcher and the forward (one CUDA graph a
                     dispatch bucket on the card), ServingStats, admission
                     control
    client.py      — RemotePolicy / RemoteBatchedPolicy (the local
                     policies' surface, served)

The serving fleet (the JAX package's ``router.py``: several servers
behind a shard router) is not ported.
"""

from r2d2_tpu_torch.serve.client import RemoteBatchedPolicy, RemotePolicy
from r2d2_tpu_torch.serve.server import (PolicyServer, ServingStats,
                                         collect_batch, serve_buckets)
from r2d2_tpu_torch.serve.state_cache import MisroutedClient, StateCache
from r2d2_tpu_torch.serve.transport import (InprocChannel, InprocEndpoint,
                                            KIND_BOOTSTRAP, KIND_DISCONNECT,
                                            KIND_STEP, Reply, Request,
                                            STATUS_EXPIRED, STATUS_MISROUTED,
                                            STATUS_OK, STATUS_RETRY,
                                            ServeTimeout, ServeUnavailable,
                                            ShmRecordRing, ShmServeChannel,
                                            ShmServeTransport, SocketChannel,
                                            SocketServerTransport)

__all__ = [
    "RemoteBatchedPolicy", "RemotePolicy", "PolicyServer", "ServingStats",
    "collect_batch", "serve_buckets", "MisroutedClient", "StateCache",
    "InprocChannel", "InprocEndpoint", "KIND_BOOTSTRAP", "KIND_DISCONNECT",
    "KIND_STEP", "Reply", "Request", "STATUS_EXPIRED", "STATUS_MISROUTED",
    "STATUS_OK", "STATUS_RETRY", "ServeTimeout", "ServeUnavailable",
    "ShmRecordRing", "ShmServeChannel", "ShmServeTransport", "SocketChannel",
    "SocketServerTransport",
]
