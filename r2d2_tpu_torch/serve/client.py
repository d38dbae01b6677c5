"""Thin serving clients with the local policies' surface, the JAX
package's ``serve/client.py``.

``RemotePolicy`` mirrors ``ActorPolicy`` and ``RemoteBatchedPolicy``
mirrors ``BatchedActorPolicy`` (actor/policy.py) method for method, so the
actor loops (runtime/actor_loop.py) drive served inference unchanged:
``actor.inference="server"`` swaps the policy object and nothing else.

  * server side: frame stack, LSTM hidden, last action (the state cache),
    the batched forward, the weights;
  * client side: the epsilon-greedy draw, from the local policy's stream in
    its order (one uniform a step, one integer only when exploring). With
    the shared forward on the server, that makes served actions the local
    ones.

A client holds no model and never touches CUDA, so process actors stay
off the card. State changes (observe, observe_reset) ride on the next
forward request. A request that times out backs off on the
``WorkerHealth`` ladder (runtime/feeder.py; no breaker: a client retries
until ``max_retry_s``, then raises ``ServeUnavailable`` and worker
supervision takes over), reconnects its channel and resends with the
state changes. The reply's ``weight_version`` becomes the client's, the
stamp the actor puts on its blocks.
"""

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from r2d2_tpu_torch.serve.transport import (KIND_BOOTSTRAP, KIND_STEP, Reply,
                                            Request, STATUS_OK, STATUS_RETRY,
                                            ServeUnavailable)


class _Lane:
    """One client identity: pending state changes and counters.
    ``op_seq`` advances once a logical operation (``begin_op``) and stays
    across its retries, so the server can replay an applied operation's
    reply; ``req_seq`` advances per attempt, so every request has a fresh
    id."""

    __slots__ = ("client_id", "req_seq", "op_seq", "pending_reset",
                 "pending_obs", "pending_action")

    def __init__(self, client_id: int):
        self.client_id = int(client_id)
        self.req_seq = 0
        self.op_seq = 0
        self.pending_reset: Optional[np.ndarray] = None
        self.pending_obs: Optional[np.ndarray] = None
        self.pending_action: int = -1

    def begin_op(self) -> None:
        self.op_seq += 1

    def build(self, kind: int) -> Request:
        self.req_seq += 1
        # the lane id in the high bits: pipelined lanes on one channel
        # never share a request id
        req = Request(client_id=self.client_id,
                      req_id=(self.client_id << 32) | self.req_seq,
                      kind=kind, op_seq=self.op_seq,
                      t_submit=time.monotonic())
        if self.pending_reset is not None:
            req.reset_obs = self.pending_reset
        elif self.pending_obs is not None:
            req.obs = self.pending_obs
            req.action = self.pending_action
        return req

    def clear(self) -> None:
        self.pending_reset = None
        self.pending_obs = None
        self.pending_action = -1

    def observe_reset(self, obs: np.ndarray) -> None:
        self.pending_reset = np.ascontiguousarray(obs, np.uint8)
        self.pending_obs = None

    def observe(self, obs: np.ndarray, action: int) -> None:
        # an unsent reset wins (it clears the stack on the server)
        if self.pending_reset is None:
            self.pending_obs = np.ascontiguousarray(obs, np.uint8)
            self.pending_action = int(action)


class _RetryPolicy:
    """Reconnect backoff on the WorkerHealth ladder (one slot, no
    breaker): the first retry at once, then doubling up to the cap."""

    def __init__(self, backoff_base_s: float = 0.25,
                 backoff_max_s: float = 5.0):
        from r2d2_tpu_torch.runtime.feeder import WorkerHealth
        self.health = WorkerHealth(
            1, None, backoff_base_s=backoff_base_s,
            backoff_max_s=backoff_max_s, max_restarts_per_window=0)
        self.failures = 0

    def on_failure(self) -> None:
        self.failures += 1
        self.health.on_failure(0, time.time())

    def wait(self, should_stop: Optional[Callable[[], bool]] = None) -> None:
        while not self.health.respawn_due(0, time.time()):
            if should_stop is not None and should_stop():
                return
            time.sleep(0.05)


class _RemoteBase:
    def __init__(self, channel, action_dim: int, *, stats=None,
                 timeout_s: float = 5.0, max_retry_s: float = 60.0,
                 backoff_base_s: float = 0.25, backoff_max_s: float = 5.0,
                 should_stop: Optional[Callable[[], bool]] = None,
                 trace_every: int = 0):
        self.channel = channel
        # every trace_every-th exchange attaches a trace dict to its
        # requests (telemetry/tracing.py); 0 = never, and requests are
        # what they are without tracing
        self._trace_every = max(int(trace_every), 0)
        self._exchanges = 0
        self.action_dim = int(action_dim)
        self.stats = stats
        self.timeout_s = timeout_s
        self.max_retry_s = max_retry_s
        self._backoff = (backoff_base_s, backoff_max_s)
        self._retry = _RetryPolicy(backoff_base_s, backoff_max_s)
        # shed pacing is a ladder of its own, reset once an exchange
        # completes: a server that sheds but still progresses every tick
        # must not walk its clients to the multi-second cap
        self._shed_retry = _RetryPolicy(backoff_base_s, backoff_max_s)
        self._should_stop = should_stop
        self.weight_version = 0
        self.timeouts = 0
        self.reconnects = 0
        self.shed_retries = 0

    def update_params(self, params) -> None:
        """Nothing: the server owns the weights."""

    def _exchange_many(self, lanes: List[_Lane], kind: int) -> List[Reply]:
        """Pipelined request/reply for every lane, with per-lane retries on
        the backoff ladder. A lane's state changes go into every attempt
        and are cleared only on an OK reply: a request the server expired
        (never applied) keeps them for the resend."""
        t0 = time.monotonic()
        for lane in lanes:
            lane.begin_op()
        reqs = {lane.client_id: lane.build(kind) for lane in lanes}
        traced = (self._trace_every
                  and self._exchanges % self._trace_every == 0)
        self._exchanges += 1
        if traced:
            from r2d2_tpu_torch.telemetry.tracing import new_request_trace
            for req in reqs.values():
                req.trace = new_request_trace(req.req_id)
        out: dict = {}
        while True:
            pending = [lane for lane in lanes if lane.client_id not in out]
            if not pending:
                break
            if traced:
                # the route hop ends at the send (a rebuilt request of a
                # retry carries no trace)
                now_wall = time.time()
                for lane in pending:
                    tr = getattr(reqs[lane.client_id], "trace", None)
                    if tr is not None:
                        tr["t_send_wall"] = now_wall
            got = self.channel.request_many(
                [reqs[lane.client_id] for lane in pending],
                timeout=self.timeout_s)
            now = time.monotonic()
            missing, expired, shed = [], [], []
            for lane in pending:
                reply = got.get(reqs[lane.client_id].req_id)
                if reply is None:
                    missing.append(lane)
                elif reply.status == STATUS_OK:
                    out[lane.client_id] = reply
                elif reply.status == STATUS_RETRY:
                    shed.append((lane, reply))
                else:
                    expired.append(lane)
            if now - t0 > self.max_retry_s and (missing or expired or shed):
                raise ServeUnavailable(
                    f"policy server unreachable for {now - t0:.1f}s")
            if self._should_stop is not None and self._should_stop() \
                    and (missing or expired or shed):
                raise ServeUnavailable("stopped while retrying")
            # EXPIRED: not applied; rebuild with a fresh id and resend,
            # paced on the ladder so it cannot spin
            for lane in expired:
                reqs[lane.client_id] = lane.build(kind)
            # SHED: not applied; the same, after the server's hint
            if shed:
                self.shed_retries += len(shed)
                for lane, _r in shed:
                    reqs[lane.client_id] = lane.build(kind)
            if shed and not missing:
                pause = max(r.retry_after_ms for _, r in shed) / 1e3
                if pause > 0:
                    time.sleep(min(pause, 1.0))
            if expired and not missing:
                self._retry.on_failure()
                self._retry.wait(self._should_stop)
            elif shed and not missing:
                self._shed_retry.on_failure()
                self._shed_retry.wait(self._should_stop)
            if missing:
                self.timeouts += len(missing)
                if self.stats is not None:
                    for _ in missing:
                        self.stats.on_timeout(self.timeout_s)
                self._retry.on_failure()
                self._retry.wait(self._should_stop)
                self.channel.reconnect()
                self.reconnects += 1
                # fresh ids: a late copy of the old ones expires on the
                # server
                for lane in missing:
                    reqs[lane.client_id] = lane.build(kind)
        elapsed = time.monotonic() - t0
        if self._shed_retry.failures:
            self._shed_retry = _RetryPolicy(*self._backoff)
        if self.stats is not None:
            for _ in lanes:
                self.stats.on_request_latency(elapsed)
        replies = []
        for lane in lanes:
            reply = out[lane.client_id]
            lane.clear()
            self.weight_version = reply.weight_version
            replies.append(reply)
        return replies

    def close(self) -> None:
        try:
            for lane in self._lanes():
                self.channel.disconnect(lane.client_id)
            self.channel.close()
        except Exception:
            pass

    def _lanes(self) -> List[_Lane]:
        raise NotImplementedError


class RemotePolicy(_RemoteBase):
    """``ActorPolicy`` over a serve channel, for ``run_actor``."""

    def __init__(self, channel, action_dim: int, epsilon: float,
                 seed: int = 0, client_id: int = 0, **kw):
        super().__init__(channel, action_dim, **kw)
        self.epsilon = float(epsilon)
        self.rng = np.random.default_rng(seed)
        self._lane = _Lane(client_id)

    def _lanes(self) -> List[_Lane]:
        return [self._lane]

    def reset_state(self) -> None:
        self._lane.clear()

    def observe_reset(self, obs: np.ndarray) -> None:
        self._lane.observe_reset(obs)

    def observe(self, obs: np.ndarray, action: int) -> None:
        self._lane.observe(obs, action)

    def step(self) -> Tuple[int, np.ndarray, np.ndarray]:
        (reply,) = self._exchange_many([self._lane], KIND_STEP)
        return int(reply.action), np.asarray(reply.q), \
            np.asarray(reply.hidden)

    def act(self) -> Tuple[int, np.ndarray, np.ndarray]:
        action, q, hidden = self.step()
        if self.rng.random() < self.epsilon:
            action = int(self.rng.integers(self.action_dim))
        return action, q, hidden

    def bootstrap_q(self) -> np.ndarray:
        (reply,) = self._exchange_many([self._lane], KIND_BOOTSTRAP)
        return np.asarray(reply.q)


class RemoteBatchedPolicy(_RemoteBase):
    """``BatchedActorPolicy`` over a serve channel, for
    ``run_vector_actor``. Lane i is client ``client_base + i`` on the
    server (its position on the fleet's epsilon ladder), and every tick
    sends all lanes' requests before collecting any reply, which is what
    fills the server's batch."""

    def __init__(self, channel, action_dim: int,
                 epsilons: Sequence[float], seeds: Sequence[int],
                 client_base: int = 0, **kw):
        super().__init__(channel, action_dim, **kw)
        if len(epsilons) != len(seeds):
            raise ValueError(
                f"epsilons ({len(epsilons)}) and seeds ({len(seeds)}) must "
                "have one entry per lane")
        self.num_lanes = len(epsilons)
        self.epsilons = np.asarray(epsilons, np.float64)
        self.rngs = [np.random.default_rng(s) for s in seeds]
        self._lane_list = [_Lane(client_base + i)
                           for i in range(self.num_lanes)]

    def _lanes(self) -> List[_Lane]:
        return self._lane_list

    def reset_state(self) -> None:
        for lane in self._lane_list:
            lane.clear()

    def reset_lane(self, lane: int) -> None:
        self._lane_list[lane].clear()

    def observe_reset_lane(self, lane: int, obs: np.ndarray) -> None:
        self._lane_list[lane].observe_reset(obs)

    def observe(self, obs: np.ndarray, actions: np.ndarray) -> None:
        for i, lane in enumerate(self._lane_list):
            lane.observe(obs[i], int(actions[i]))

    def step(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        replies = self._exchange_many(self._lane_list, KIND_STEP)
        actions = np.asarray([r.action for r in replies], np.int64)
        q = np.stack([np.asarray(r.q) for r in replies])
        hidden = np.stack([np.asarray(r.hidden) for r in replies])
        return actions, q, hidden

    def act(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        actions, q, hidden = self.step()
        actions = np.array(actions)
        for i, rng in enumerate(self.rngs):
            if rng.random() < self.epsilons[i]:
                actions[i] = int(rng.integers(self.action_dim))
        return actions, q, hidden

    def bootstrap_q(self) -> np.ndarray:
        replies = self._exchange_many(self._lane_list, KIND_BOOTSTRAP)
        return np.stack([np.asarray(r.q) for r in replies])
