"""Server-side per-client acting state, the JAX package's
``serve/state_cache.py``.

``ActorPolicy``/``BatchedActorPolicy`` keep three pieces of per-episode
state on the actor's host: the packed LSTM hidden, the rolling frame stack
and the last action (actor/policy.py). The policy server keeps that state
here instead, keyed by client id, so a thin client sends one raw frame a
step and the recurrent state never crosses the wire (SEED's placement).
Host numpy, as in the JAX package; the server gathers a batch's rows and
copies them to the card.

The cache is sharded: client ids hash onto ``shards`` slot groups, each
with its own lease table. Leases:

  * ``lease``   — client -> slot. A new client takes a free slot; a known
    one renews (and, if it had disconnected, reconnects to its kept
    state). A full shard evicts the stalest releasable lease
    (disconnected first, then the oldest idle) and resets the slot.
  * ``release`` — disconnect: the state is kept for ``lease_timeout_s``.
  * ``sweep``   — evict disconnected leases idle past the timeout.

State changes are the local policies' math exactly (observe_reset's
broadcast fill, observe's roll), so a served actor's blocks equal a local
one's. ``owned_shards``/``total_shards`` keep the JAX package's fleet
layout parameters; handing a shard group to another server waits for the
router (serve/router.py), which the port does not have yet.
"""

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class MisroutedClient(Exception):
    """A client whose shard group this cache does not own (only possible
    with ``owned_shards`` narrower than the hash space)."""

    def __init__(self, shard: int):
        super().__init__(f"client shard {shard} not owned by this cache")
        self.shard = shard


class StateCache:
    """``owned_shards``/``total_shards``: this cache holds only the named
    shard groups of a ``total_shards``-wide hash space (owned position p
    covers slots ``[p*per_shard, (p+1)*per_shard)``); by default it owns
    every shard, the single-server layout."""

    def __init__(self, slots: int, shards: int, frame_hw: Tuple[int, int],
                 frame_stack: int, hidden_dim: int,
                 lease_timeout_s: float = 120.0, action_dim: int = 1,
                 owned_shards: Optional[Sequence[int]] = None,
                 total_shards: Optional[int] = None):
        if shards > 0 and slots % shards != 0:
            raise ValueError(f"state slots ({slots}) must be divisible by "
                             f"shards ({shards})")
        self.slots = slots
        self.shards = shards
        self.per_shard = slots // shards if shards else 0
        self.total_shards = shards if total_shards is None else total_shards
        self._owned = (list(range(shards)) if owned_shards is None
                       else [int(g) for g in owned_shards])
        if len(self._owned) != shards:
            raise ValueError(
                f"owned_shards has {len(self._owned)} entries for "
                f"{shards} shard groups")
        self._pos = {g: p for p, g in enumerate(self._owned)}
        self.lease_timeout_s = lease_timeout_s
        self._frame_hw = tuple(frame_hw)
        self._frame_stack = frame_stack
        self._hidden_dim = hidden_dim
        self._action_dim = action_dim
        h, w = frame_hw
        self.hidden = np.zeros((slots, 2, hidden_dim), np.float32)
        self.stacked = np.zeros((slots, h, w, frame_stack), np.float32)
        self.last_action = np.full(slots, -1, np.int32)
        # Idempotent-RPC bookkeeping: the last APPLIED logical operation
        # per slot plus its cached result. A retried op (client timed
        # out, reply lost, but the first copy WAS processed) replays the
        # cached action/Q instead of re-rolling the frame stack and
        # re-advancing the hidden — one logical step mutates state
        # exactly once no matter how many copies reach the server.
        self.op_seq = np.full(slots, -1, np.int64)
        self.reply_action = np.zeros(slots, np.int64)
        self.reply_q = np.zeros((slots, max(action_dim, 1)), np.float32)
        # lease bookkeeping: slot -> client (-1 free) + per-shard maps
        self._slot_client = np.full(slots, -1, np.int64)
        self._last_seen = np.zeros(slots, np.float64)
        self._connected = np.zeros(slots, bool)
        self._leases: List[Dict[int, int]] = [dict() for _ in range(shards)]
        self.connects = 0
        self.reconnects = 0
        self.evictions = 0

    # -- leases --

    def _shard_of(self, client_id: int) -> int:
        g = int(client_id) % self.total_shards
        p = self._pos.get(g)
        if p is None:
            raise MisroutedClient(g)
        return p

    @property
    def owned_shards(self) -> List[int]:
        return list(self._owned)

    @property
    def active_clients(self) -> int:
        return int(self._connected.sum())

    @property
    def leased_slots(self) -> int:
        return int((self._slot_client >= 0).sum())

    def lease(self, client_id: int,
              now: Optional[float] = None) -> Tuple[int, bool]:
        """Resolve ``client_id`` to its slot; returns ``(slot, fresh)``
        where ``fresh`` means the slot holds NO prior state for this
        client (new connect or post-eviction re-admit) and the caller
        must reset it before use."""
        now = time.monotonic() if now is None else now
        s = self._shard_of(client_id)
        leases = self._leases[s]
        slot = leases.get(int(client_id))
        if slot is not None:
            if not self._connected[slot]:
                self.reconnects += 1     # retained state, resumed
            self._connected[slot] = True
            self._last_seen[slot] = now
            return slot, False
        slot = self._find_slot(s, now)
        leases[int(client_id)] = slot
        self._slot_client[slot] = int(client_id)
        self._connected[slot] = True
        self._last_seen[slot] = now
        self.connects += 1
        return slot, True

    def _find_slot(self, shard: int, now: float) -> int:
        lo, hi = shard * self.per_shard, (shard + 1) * self.per_shard
        owners = self._slot_client[lo:hi]
        free = np.flatnonzero(owners < 0)
        if len(free):
            return lo + int(free[0])
        # full shard: evict the stalest releasable lease — disconnected
        # leases first (their clients already left), else the oldest-idle
        # connected one (admission beats starvation; the evictee's next
        # request re-admits it with fresh state)
        ages = self._last_seen[lo:hi]
        disc = np.flatnonzero(~self._connected[lo:hi])
        cand = disc if len(disc) else np.arange(self.per_shard)
        victim = lo + int(cand[np.argmin(ages[cand])])
        self._evict(shard, victim)
        return victim

    def _evict(self, shard: int, slot: int) -> None:
        owner = int(self._slot_client[slot])
        self._leases[shard].pop(owner, None)
        self._slot_client[slot] = -1
        self._connected[slot] = False
        self.reset_slot(slot)
        self.reset_op(slot)
        self.evictions += 1

    def release(self, client_id: int,
                now: Optional[float] = None) -> bool:
        """Client disconnect: keep the state, mark the lease releasable.
        Returns True when the client actually held a lease."""
        now = time.monotonic() if now is None else now
        s = self._shard_of(client_id)
        slot = self._leases[s].get(int(client_id))
        if slot is None:
            return False
        self._connected[slot] = False
        self._last_seen[slot] = now
        return True

    def sweep(self, now: Optional[float] = None) -> int:
        """Evict disconnected leases idle past ``lease_timeout_s``;
        returns the number evicted."""
        now = time.monotonic() if now is None else now
        evicted = 0
        leased = np.flatnonzero(self._slot_client >= 0)
        for slot in leased:
            if (not self._connected[slot]
                    and now - self._last_seen[slot] > self.lease_timeout_s):
                self._evict(slot // self.per_shard, int(slot))
                evicted += 1
        return evicted

    # -- state mutations (the local policies' exact math) --

    def reset_slot(self, slot: int, obs: Optional[np.ndarray] = None) -> None:
        """Per-episode reset (ActorPolicy.reset_state / observe_reset):
        zero hidden, ``obs`` (if given) broadcast across the stack."""
        self.hidden[slot] = 0.0
        self.last_action[slot] = -1
        if obs is None:
            self.stacked[slot] = 0.0
        else:
            self.stacked[slot] = \
                (np.asarray(obs, np.float32) / 255.0)[..., None]

    def observe(self, slot: int, obs: np.ndarray, action: int) -> None:
        """Frame-stack roll + last-action record (ActorPolicy.observe)."""
        self.stacked[slot] = np.roll(self.stacked[slot], -1, axis=-1)
        self.stacked[slot][..., -1] = np.asarray(obs, np.float32) / 255.0
        self.last_action[slot] = np.int32(action)

    # -- batch assembly --

    def gather(self, slots: List[int]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        idx = np.asarray(slots, np.int64)
        return (self.stacked[idx], self.last_action[idx], self.hidden[idx])

    def write_hidden(self, slot: int, hidden: np.ndarray) -> None:
        self.hidden[slot] = hidden

    # -- idempotent-op bookkeeping --

    def reset_op(self, slot: int) -> None:
        """Forget the slot's op history (fresh lease / eviction) — a new
        client's op numbering starts over."""
        self.op_seq[slot] = -1

    def record_op(self, slot: int, op_seq: int, action: int,
                  q: np.ndarray) -> None:
        self.op_seq[slot] = op_seq
        self.reply_action[slot] = action
        self.reply_q[slot] = q

    def cached_reply(self, slot: int) -> Tuple[int, np.ndarray]:
        return int(self.reply_action[slot]), self.reply_q[slot].copy()
