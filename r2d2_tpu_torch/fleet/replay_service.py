"""The replay service: N addressable device replay shards behind one
producer/consumer interface, with a host spill tier, the JAX package's
``fleet/replay_service.py``.

Any producer routes blocks into a shard by its key (the device replay's
``replay_add`` / ``replay_add_many`` ring writes), any consumer draws a
prioritized batch from the next non-empty shard (``replay_sample``: the
sum-tree descent, then the window gather kernel on the card) and writes
priorities back (``replay_update_priorities``). Every shard's tensors
live on one device, the learner's.

The spill tier: a shard keeps a host page (numpy) of each block it holds,
taken from the block the producer handed in, never read back from the
card. A ring write over a live block demotes that block's page into an
LRU page store instead of destroying it; pages are promoted back into the
samplable ring, ``spill_promote_per_sample`` at a time, inside the sample
call (or, with ``spill_prefetch``, by stored priority on a background
thread kicked at write-back time). With the tier cold the sample is
exactly ``replay_sample`` on the shard's state.

Routing: ``"round_robin"`` (block k to shard k % N, the dp path's feeding
order) or ``"lane"`` (the block's lane stamp mod N; an unstamped block,
lane -1, round robin).

Grouped ingest (``ingest_batch_blocks`` K > 1): ``add_blocks`` routes a
group in arrival order (the round-robin counter advances as K
``add_block`` calls would), groups it by shard and commits each shard's
run through ``replay_add_many`` in chunks of K while K remain, then the
largest power of two, a chunk of one through ``replay_add``: ring rows,
spill demotions (order and LRU position), lane, version and lineage
stamps and the eviction ledger equal K sequential adds.

Priority write-backs carry the sample's adds count (the staleness token):
rows overwritten since the sample are dropped whole-batch without the
spill tier, and with it written into their demoted page's stored
priorities, the fresh rows applied by the same-shape update.

Threads and streams: every device operation of the service (adds,
promotions, samples, write-backs, snapshot copies) runs under the
service's lock and on one stream, the current stream of the thread that
built the service (the learner's), so the card runs them in the order the
lock admitted them, whichever thread enqueued them.

The socket rung (``ReplayServiceServer``, ``RemoteReplayProducer``,
``ReplayProducerPump``): length-prefixed pickle frames of numpy arrays
(serve/transport.py ``send_frame`` / ``recv_frame``), never torch
tensors, so a producer without CUDA feeds a service on the card. ``add``
frames are acked one by one with the routed shard; ``addw`` frames carry
a stacked group, up to ``window`` of them in flight, acked cumulatively
(an ack for seq confirms every frame up to it), ``flushw`` always acked:
the resync point. A producer redials on a backoff ladder and replays its
unacked tail when the service dies.
"""

import contextlib
import dataclasses
import heapq
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.replay.device_replay import (replay_add, replay_add_many,
                                                 replay_init, replay_sample,
                                                 replay_update_priorities)
from r2d2_tpu_torch.replay.structs import (Block, ReplaySpec, RingAccountant,
                                           block_trace, stack_blocks,
                                           with_trace)
from r2d2_tpu_torch.telemetry.histogram import (NBUCKETS, bucket_index,
                                                summarize)
from r2d2_tpu_torch.telemetry.tracing import now_ms
from r2d2_tpu_torch.utils.device import resolve_device


def _block_fields(block: Block) -> Dict[str, np.ndarray]:
    """Block -> {field: numpy}, its lineage stamp as ``trace_ms`` when it
    carries one: a socket frame's and a snapshot page's record."""
    out = {f.name: np.asarray(getattr(block, f.name))
           for f in dataclasses.fields(Block)}
    trace = block_trace(block)
    if trace is not None:
        out["trace_ms"] = np.asarray(trace)
    return out


def block_from_fields(fields: Dict[str, np.ndarray]) -> Block:
    """``_block_fields``' inverse."""
    fields = dict(fields)
    trace = fields.pop("trace_ms", None)
    return with_trace(Block(**fields), trace)


def _host_block(block: Block) -> Block:
    """The block's leaves as host numpy arrays (a page of the spill tier;
    the drain's blocks are numpy already), its stamp kept."""
    return block_from_fields(_block_fields(block))


def _with_priority(block: Block, priority: np.ndarray) -> Block:
    return with_trace(dataclasses.replace(block, priority=priority),
                      block_trace(block))


class SpillTier:
    """Host LRU page store for blocks demoted from a device ring.

    A page is one block (host numpy) and its accounting (learning steps,
    weight version). ``demote`` inserts at the MRU end and drops the LRU
    page when the tier is full (an eviction: that experience is gone);
    ``promote_next`` pops the LRU page for re-insertion into the ring (a
    hit). ``hit_rate`` is promotions over promotions and evictions;
    ``take_interval``'s ``thrash_frac`` (evictions over demotions of the
    interval) is the ``spill_thrash`` alert's signal.

    Every page also carries its highest stored leaf priority (the raw
    |TD| record ``block.priority`` that the add seeds the tree from):
    ``promote_best`` pops the highest through a lazy-deletion max-heap,
    and ``write_back`` writes a post-demotion priority into a page in
    place. Eviction stays LRU in both modes."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._pages: "OrderedDict[int, tuple]" = OrderedDict()
        # page id -> highest stored leaf priority; the heap holds
        # (-priority, id), stale entries skipped on pop
        self._prio: Dict[int, float] = {}
        self._heap: List[Tuple[float, int]] = []
        self._next_id = 1          # 1-based: a page id is always truthy
        self.demotions = 0
        self.promotions = 0
        self.evictions = 0
        self.writebacks = 0
        self._interval = [0, 0, 0]   # demotions, promotions, evictions
        # a resident page's demotion time (monotonic), so a promotion's
        # time in the tier lands in the 64-bucket latency histogram;
        # page_bytes from the first page (every page weighs the same)
        self._demoted_at: Dict[int, float] = {}
        self._promo_lat = np.zeros(NBUCKETS, np.int64)
        self.page_bytes = 0

    @property
    def occupancy(self) -> int:
        return len(self._pages)

    def demote(self, block: Block, learning: int,
               weight_version: int) -> Optional[int]:
        """Insert one demoted page; its page id (the write-back routing
        token), or None with the tier off (capacity 0: the page is lost,
        as an overwrite without the tier loses it)."""
        if self.capacity <= 0:
            return None
        pid = self._next_id
        self._next_id += 1
        self._pages[pid] = (block, int(learning), int(weight_version))
        prio = float(np.max(np.asarray(block.priority)))
        self._prio[pid] = prio
        heapq.heappush(self._heap, (-prio, pid))
        self.demotions += 1
        self._interval[0] += 1
        self._demoted_at[pid] = time.monotonic()
        if not self.page_bytes:
            self.page_bytes = sum(
                np.asarray(v).nbytes for v in _block_fields(block).values())
        if len(self._pages) > self.capacity:
            old_id, _ = self._pages.popitem(last=False)
            self._prio.pop(old_id, None)
            self._demoted_at.pop(old_id, None)
            self.evictions += 1
            self._interval[2] += 1
        return pid

    def promote_next(self) -> Optional[tuple]:
        """Pop the least recently demoted page; None when empty."""
        if not self._pages:
            return None
        pid, page = self._pages.popitem(last=False)
        self._prio.pop(pid, None)
        self._note_promo(pid)
        self.promotions += 1
        self._interval[1] += 1
        return page

    def promote_best(self) -> Optional[tuple]:
        """Pop the page of the highest stored priority (evicted,
        promoted and re-written ids skipped); None when empty."""
        while self._heap:
            neg_prio, pid = heapq.heappop(self._heap)
            if self._prio.get(pid) != -neg_prio or pid not in self._pages:
                continue
            page = self._pages.pop(pid)
            self._prio.pop(pid, None)
            self._note_promo(pid)
            self.promotions += 1
            self._interval[1] += 1
            return page
        return None

    def _note_promo(self, pid: int) -> None:
        t = self._demoted_at.pop(pid, None)
        if t is not None:
            self._promo_lat[bucket_index(time.monotonic() - t)] += 1

    def take_promotion_latency(self) -> Optional[dict]:
        """The interval's time in the tier of promoted pages (reset on
        read); None when none was promoted."""
        s = summarize(self._promo_lat)
        self._promo_lat[:] = 0
        return s

    def write_back(self, page_id: int, seq: int, abs_td: float) -> bool:
        """Write one sequence's new |TD| into a spilled page's stored
        priorities (what the add seeds the tree from at promotion).
        False when the page is gone (evicted or promoted): the caller
        counts a dropped row."""
        page = self._pages.get(page_id)
        if page is None:
            return False
        block, learning, wv = page
        prio = np.array(np.asarray(block.priority), copy=True)
        if not 0 <= seq < prio.shape[0]:
            return False
        prio[seq] = abs_td
        self._pages[page_id] = (_with_priority(block, prio), learning, wv)
        new_max = float(np.max(prio))
        self._prio[page_id] = new_max
        heapq.heappush(self._heap, (-new_max, page_id))
        self.writebacks += 1
        return True

    @property
    def hit_rate(self) -> Optional[float]:
        """Promoted / (promoted + evicted), None before either."""
        done = self.promotions + self.evictions
        return round(self.promotions / done, 4) if done else None

    def take_interval(self) -> dict:
        """The interval's demotions, promotions, evictions and thrash
        fraction (reset on read)."""
        d, p, e = self._interval
        self._interval = [0, 0, 0]
        return {"demotions": d, "promotions": p, "evictions": e,
                "thrash_frac": (round(e / d, 4) if d else None)}


class ReplayShard:
    """One addressable shard: a device replay (replay/device_replay.py),
    its RingAccountant, and with the spill tier on the host page of each
    ring slot (the demotion source) and the page id each slot's last
    occupant demoted to (the write-back routing table)."""

    def __init__(self, spec: ReplaySpec, index: int, device,
                 spill_blocks: int = 0):
        self.spec = spec
        self.index = index
        self.state = replay_init(spec, device)
        self.ring = RingAccountant(spec.num_blocks)
        self.spill = SpillTier(spill_blocks)
        self._retain = spill_blocks > 0
        self._resident: List[Optional[tuple]] = [None] * spec.num_blocks
        self._demote_ids: List[Optional[int]] = [None] * spec.num_blocks

    @staticmethod
    def _meta(block: Block) -> Tuple[int, int, Optional[int]]:
        trace = block_trace(block)
        return (int(np.asarray(block.learning_steps).sum()),
                int(np.asarray(block.weight_version)),
                None if trace is None else int(np.asarray(trace)))

    def _advance(self, learning: int, wv: int,
                 trace: Optional[int]) -> None:
        if trace is None:
            self.ring.advance(learning, wv)
        else:
            self.ring.advance(learning, wv, trace_ms=trace,
                              ingest_ms=(now_ms() if trace >= 0 else -1))

    def _demote_slot(self, slot: int) -> None:
        old = self._resident[slot]
        if old is not None and self.ring.slot_steps[slot] > 0:
            self._demote_ids[slot] = self.spill.demote(*old)

    def add(self, block: Block) -> int:
        """Ring-write one block (``replay_add``), demoting the overwritten
        slot's page first; the slot it landed in."""
        learning, wv, trace = self._meta(block)
        slot = self.ring.ptr
        if self._retain:
            block = _host_block(block)
            self._demote_slot(slot)
        replay_add(self.spec, self.state, block)
        self._advance(learning, wv, trace)
        if self._retain:
            self._resident[slot] = (block, learning, wv)
        return slot

    def add_group(self, blocks: List[Block],
                  max_chunk: int) -> Tuple[int, float, float]:
        """Commit a routed group through ``replay_add_many`` in chunks:
        ``max_chunk`` while that many remain, then the largest power of
        two, a chunk of one through ``add``. A chunk's rows ``(ptr + j) %
        n`` are distinct (chunks never exceed num_blocks), so its
        demotions and their LRU order are the sequential adds'. Returns
        (chunks, stage seconds, commit seconds)."""
        dispatches, stage_s, commit_s = 0, 0.0, 0.0
        n = self.spec.num_blocks
        i, total = 0, len(blocks)
        while i < total:
            rem = total - i
            k = max_chunk if rem >= max_chunk else 1 << (rem.bit_length() - 1)
            if k == 1:
                t0 = time.perf_counter()
                self.add(blocks[i])
                commit_s += time.perf_counter() - t0
                dispatches += 1
                i += 1
                continue
            t0 = time.perf_counter()
            chunk = blocks[i:i + k]
            if self._retain:
                chunk = [_host_block(b) for b in chunk]
            metas = [self._meta(b) for b in chunk]
            stacked = stack_blocks(chunk)
            t1 = time.perf_counter()
            slots = [(self.ring.ptr + j) % n for j in range(k)]
            if self._retain:
                for slot in slots:
                    self._demote_slot(slot)
            replay_add_many(self.spec, self.state, stacked)
            for learning, wv, trace in metas:
                self._advance(learning, wv, trace)
            if self._retain:
                for slot, blk, (learning, wv, _) in zip(slots, chunk, metas):
                    self._resident[slot] = (blk, learning, wv)
            t2 = time.perf_counter()
            stage_s += t1 - t0
            commit_s += t2 - t1
            dispatches += 1
            i += k
        return dispatches, stage_s, commit_s

    def promote(self, n: int, by_priority: bool = False) -> int:
        """Rotate up to ``n`` spilled pages back into the ring (each
        re-entry demotes what it overwrites), LRU first or by stored
        priority; the pages promoted."""
        done = 0
        for _ in range(max(n, 0)):
            page = (self.spill.promote_best() if by_priority
                    else self.spill.promote_next())
            if page is None:
                break
            self.add(page[0])
            done += 1
        return done

    def sample(self, generator: Optional[torch.Generator] = None,
               uniform: Optional[torch.Tensor] = None):
        return replay_sample(self.spec, self.state, generator=generator,
                             uniform=uniform)

    def update_priorities(self, idxes, td_errors) -> None:
        """The tree update from device tensors or host arrays. Host arrays
        on CUDA copy through pinned memory without blocking the host, as
        ``replay_add_many``'s: a pageable copy would wait for every
        dispatch already on the stream (the learner's graph)."""
        device = self.state.tree.device
        cuda = device.type == "cuda"

        def t(x, dtype):
            x = torch.as_tensor(x)
            if x.device == device:
                return x.to(dtype)
            host = x.to(dtype)
            if cuda:
                host = host.pin_memory()
            return host.to(device, non_blocking=cuda)

        replay_update_priorities(self.spec, self.state,
                                 t(idxes, torch.int64),
                                 t(td_errors, torch.float32))

    @property
    def live_blocks(self) -> int:
        return sum(1 for s in self.ring.slot_steps if s > 0)

    @property
    def fill(self) -> float:
        cap = self.spec.num_blocks * self.spec.block_length
        return round(self.ring.buffer_steps / cap, 4) if cap else 0.0


ROUTES = ("round_robin", "lane")
# the service's operations whose host time ``host_timings`` reports
HOST_OPS = ("add", "sample", "promote", "writeback", "trace")


class ReplayService:
    """N shards behind one producer/consumer interface, with the ring
    accountant's facade (``buffer_steps``, ``total_adds``,
    ``live_versions``) that the Learner's gate and metrics read."""

    def __init__(self, spec: ReplaySpec, num_shards: int, device=None,
                 spill_blocks: int = 0, route: str = "round_robin",
                 promote_per_sample: int = 1,
                 ingest_batch_blocks: int = 1,
                 spill_prefetch: bool = False,
                 tier_stats: bool = False):
        if num_shards < 1:
            raise ValueError(f"num_shards ({num_shards}) must be >= 1")
        if route not in ROUTES:
            raise ValueError(f"route {route!r} must be one of {ROUTES}")
        self.spec = spec
        # the card unless the caller asks for the CPU (raises without one)
        self.device = resolve_device(device)
        self.num_shards = num_shards
        self.route = route
        self.promote_per_sample = promote_per_sample
        self.spill_prefetch = bool(spill_prefetch)
        # the per-tier sub-blocks (telemetry.replay_tiers_enabled)
        self.tier_stats = bool(tier_stats)
        self.ingest_k = max(int(ingest_batch_blocks), 1)
        # the one stream every device operation of the service runs on
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        with self.on_stream():
            self.shards = [ReplayShard(spec, s, self.device, spill_blocks)
                           for s in range(num_shards)]
        self._rr_add = 0
        self._rr_sample = 0
        self._lock = threading.Lock()
        # host seconds by operation: [calls, waiting for the lock, holding
        # it] (``host_timings``). A promotion's hold is its own, not its
        # caller's (the sample's or the prefetch pass's)
        self._host_s: Dict[str, list] = {op: [0, 0.0, 0.0]
                                         for op in HOST_OPS}
        # write-backs dropped whole by the staleness guard (no spill
        # tier), rows routed to spilled pages, rows whose page was gone
        self.stale_writebacks = 0
        self.spilled_writebacks = 0
        self.stale_rows_dropped = 0
        self._max_chunk = min(self.ingest_k, spec.num_blocks)
        # the interval's ingest counters: blocks, chunks, stage s, commit
        # s (reset by interval_block), and the producer-side backlog
        self._ingest_iv = [0, 0, 0.0, 0.0]
        self._backlog = 0
        # the spill prefetch: shards waiting for a promotion pass, run by
        # a background thread started on the first kick
        self._prefetch_pending: set = set()
        self._prefetch_event = threading.Event()
        self._prefetch_stop = threading.Event()
        self._prefetch_thread: Optional[threading.Thread] = None
        self._prefetch_error: Optional[BaseException] = None
        self._prefetch_iv = 0
        self._prefetch_popped = 0
        self._prefetch_done = 0

    def on_stream(self):
        """The service's stream as the current one (CUDA), else nothing."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    @contextlib.contextmanager
    def _held(self, op: str):
        """The lock and the stream for one ``op``: its host seconds waiting
        for the lock and holding it go to ``host_timings``. The body may
        move part of its hold to another op through ``_charge``."""
        t0 = time.perf_counter()
        with self._lock, self.on_stream():
            t1 = time.perf_counter()
            try:
                yield
            finally:
                row = self._host_s[op]
                row[0] += 1
                row[1] += t1 - t0
                row[2] += time.perf_counter() - t1

    def _charge(self, op: str, into: str, seconds: float) -> None:
        """Move ``seconds`` of ``into``'s hold to ``op`` (under the
        lock)."""
        self._host_s[op][0] += 1
        self._host_s[op][2] += seconds
        self._host_s[into][2] -= seconds

    def host_timings(self, reset: bool = False) -> dict:
        """Each operation's calls and host milliseconds waiting for the
        lock and holding it, in total and a call. A hold includes any wait
        of the host for the card inside it (a stream sync, a device read);
        the card's own time is not here."""
        with self._lock:
            rows = {op: list(r) for op, r in self._host_s.items()}
            if reset:
                self._host_s = {op: [0, 0.0, 0.0] for op in HOST_OPS}
        out = {}
        for op, (n, wait, held) in rows.items():
            out[op] = {"calls": n, "wait_ms": round(wait * 1e3, 3),
                       "held_ms": round(held * 1e3, 3),
                       "wait_ms_per_call": (round(wait * 1e3 / n, 4)
                                            if n else None),
                       "held_ms_per_call": (round(held * 1e3 / n, 4)
                                            if n else None)}
        return out

    def chunk_sizes(self) -> List[int]:
        """The chunk sizes a grouped commit takes: every power of two
        below the group size and the group size (1 goes through
        ``replay_add``)."""
        sizes, kb = [], 2
        while kb < self._max_chunk:
            sizes.append(kb)
            kb *= 2
        if self._max_chunk > 1:
            sizes.append(self._max_chunk)
        return sizes

    # -- producer side --

    def route_shard(self, block: Block) -> int:
        """The shard key: the lane stamp under "lane" routing when the
        block carries one, round robin otherwise."""
        if self.route == "lane":
            lane = int(np.asarray(block.lane))
            if lane >= 0:
                return lane % self.num_shards
        shard = self._rr_add
        self._rr_add = (self._rr_add + 1) % self.num_shards
        return shard

    def add_block(self, block: Block) -> int:
        """Route and ring-write one block; the shard it landed in."""
        with self._held("add"):
            shard = self.route_shard(block)
            self.shards[shard].add(block)
            return shard

    def add_blocks(self, blocks: List[Block]) -> List[int]:
        """Route and commit a group: at ``ingest_batch_blocks`` 1 (or one
        block) the sequential loop; above it routed in arrival order,
        grouped by shard, each shard's run in ``add_group``'s chunks.
        The routed shard of each block, in input order."""
        if self.ingest_k <= 1 or len(blocks) <= 1:
            return [self.add_block(b) for b in blocks]
        with self._held("add"):
            t0 = time.perf_counter()
            routed = [self.route_shard(b) for b in blocks]
            groups: "OrderedDict[int, List[Block]]" = OrderedDict()
            for shard, block in zip(routed, blocks):
                groups.setdefault(shard, []).append(block)
            stage_s = time.perf_counter() - t0
            dispatches, commit_s = 0, 0.0
            for shard, group in groups.items():
                d, s, c = self.shards[shard].add_group(group,
                                                       self._max_chunk)
                dispatches += d
                stage_s += s
                commit_s += c
            self._ingest_iv[0] += len(blocks)
            self._ingest_iv[1] += dispatches
            self._ingest_iv[2] += stage_s
            self._ingest_iv[3] += commit_s
            return routed

    def note_backlog(self, queued_blocks: int) -> None:
        """The producer-side queue depth seen at the last drain (the
        ``ingest_backlog`` alert's gauge; a negative depth, unknown, as
        0)."""
        self._backlog = max(int(queued_blocks), 0)

    # -- consumer side --

    def sample(self, generator: Optional[torch.Generator] = None,
               uniform: Optional[torch.Tensor] = None
               ) -> Tuple[object, int, int]:
        """One prioritized batch from the next non-empty shard (round
        robin over the shards). Spill promotion runs here, before the
        descent, unless ``spill_prefetch`` moved it to the write-back's
        background pass. ``uniform``: the descent's jitter (tests inject
        the JAX package's draws), else drawn from ``generator``. Returns
        (SampleBatch on the service's device, shard, adds snapshot: the
        write-back's staleness token)."""
        with self._held("sample"):
            for _ in range(self.num_shards):
                shard = self.shards[self._rr_sample]
                self._rr_sample = (self._rr_sample + 1) % self.num_shards
                if shard.ring.total_adds == 0:
                    continue
                if self.promote_per_sample > 0 and not self.spill_prefetch:
                    t0 = time.perf_counter()
                    shard.promote(self.promote_per_sample)
                    self._charge("promote", "sample",
                                 time.perf_counter() - t0)
                return (shard.sample(generator, uniform), shard.index,
                        shard.ring.total_adds)
        raise RuntimeError("ReplayService.sample on an empty service — "
                           "gate on all_shards_nonempty first")

    def trace_lookup(self, shard: int, idxes) -> List[Tuple[int, int]]:
        """The (emit_ms, ingest_ms) lineage stamps of a sampled batch's
        traced rows (host ``idxes``); rows of unstamped slots are
        absent."""
        sh = self.shards[shard]
        spb = self.spec.seqs_per_block
        out: List[Tuple[int, int]] = []
        with self._held("trace"):
            ring = sh.ring
            for idx in np.asarray(idxes).reshape(-1):
                slot = int(idx) // spb
                if 0 <= slot < ring.num_blocks and ring.slot_trace[slot] >= 0:
                    out.append((int(ring.slot_trace[slot]),
                                int(ring.slot_ingest_ms[slot])))
        return out

    def _update_one(self, sh: ReplayShard, idxes, td_errors,
                    adds_snapshot: Optional[int]) -> None:
        """One write-back under the held lock. With a snapshot, rows
        overwritten since it go to their demoted page's stored priorities
        (spill tier on) or drop the whole batch (off); the fresh rows
        apply through the same-shape update, stale positions padded with
        a duplicate of a fresh entry (an identical-value scatter). Host
        values are read only when an add came between the sample and
        this write-back."""
        if adds_snapshot is not None:
            delta = sh.ring.total_adds - adds_snapshot
            if delta > 0:
                n = sh.spec.num_blocks
                if delta >= n:
                    self.stale_writebacks += 1
                    return
                ptr0 = adds_snapshot % n
                overwritten = {(ptr0 + j) % n for j in range(delta)}
                spb = sh.spec.seqs_per_block
                idxes_np = np.asarray(torch.as_tensor(idxes).cpu())
                rows = idxes_np // spb
                stale = np.array([int(r) in overwritten for r in rows])
                if stale.any():
                    if not sh._retain:
                        self.stale_writebacks += 1
                        return
                    td_np = np.asarray(torch.as_tensor(td_errors).cpu(),
                                       np.float32)
                    for i in np.nonzero(stale)[0]:
                        slot = int(rows[i])
                        seq = int(idxes_np[i]) % spb
                        pid = sh._demote_ids[slot]
                        if pid is not None and sh.spill.write_back(
                                pid, seq, abs(float(td_np[i]))):
                            self.spilled_writebacks += 1
                        else:
                            self.stale_rows_dropped += 1
                    fresh = np.nonzero(~stale)[0]
                    if fresh.size == 0:
                        return
                    sel = np.where(stale, fresh[0],
                                   np.arange(idxes_np.shape[0]))
                    sh.update_priorities(idxes_np[sel], td_np[sel])
                    return
        sh.update_priorities(idxes, td_errors)

    def update_priorities(self, shard: int, idxes, td_errors,
                          adds_snapshot: Optional[int] = None) -> None:
        """Write priorities back to ``shard``, guarded by ``adds_snapshot``
        (``sample``'s token) when given."""
        with self._held("writeback"):
            self._update_one(self.shards[shard], idxes, td_errors,
                             adds_snapshot)
        self._kick_prefetch(shard)

    def update_priorities_group(
            self, shard: int,
            entries: List[Tuple[object, object, Optional[int]]]) -> None:
        """A batch of write-backs to one shard under one lock hold, in
        order, each (idxes, td_errors, adds_snapshot) with its own
        guard."""
        with self._held("writeback"):
            sh = self.shards[shard]
            for idxes, td_errors, adds_snapshot in entries:
                self._update_one(sh, idxes, td_errors, adds_snapshot)
        self._kick_prefetch(shard)

    # -- spill prefetch --

    def _kick_prefetch(self, shard: int) -> None:
        """Queue a by-priority promotion pass of ``shard`` on the
        background thread (started on first use)."""
        if not self.spill_prefetch or self.promote_per_sample <= 0:
            return
        if self._prefetch_error is not None:
            raise RuntimeError("the spill prefetch thread died"
                               ) from self._prefetch_error
        self._prefetch_pending.add(shard)
        if self._prefetch_thread is None:
            self._prefetch_thread = threading.Thread(
                target=self._prefetch_loop, daemon=True,
                name="replay-svc-prefetch")
            self._prefetch_thread.start()
        self._prefetch_event.set()

    def _prefetch_loop(self) -> None:
        try:
            while not self._prefetch_stop.is_set():
                if not self._prefetch_event.wait(timeout=0.25):
                    continue
                self._prefetch_event.clear()
                while (self._prefetch_pending
                       and not self._prefetch_stop.is_set()):
                    shard = self._prefetch_pending.pop()
                    self._prefetch_popped += 1
                    with self._held("promote"):
                        done = self.shards[shard].promote(
                            self.promote_per_sample, by_priority=True)
                        self._prefetch_iv += done
                    self._prefetch_done += 1
        except BaseException as e:       # raised at the next kick
            self._prefetch_error = e

    def drain_prefetch(self, timeout: float = 2.0) -> bool:
        """Wait until every queued prefetch pass has run; False on
        timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if (not self._prefetch_pending
                    and self._prefetch_done >= self._prefetch_popped):
                return True
            time.sleep(0.002)
        return False

    def close(self) -> None:
        """Stop the prefetch thread (idempotent)."""
        self._prefetch_stop.set()
        self._prefetch_event.set()
        if self._prefetch_thread is not None:
            self._prefetch_thread.join(timeout=2.0)
            self._prefetch_thread = None

    # -- snapshots --

    def snapshot_state(self, step: int, extra: Optional[dict] = None) -> dict:
        """A cut of every shard under the lock (replay/snapshot.py)."""
        from r2d2_tpu_torch.replay.snapshot import capture_service
        return capture_service(self, step, extra)

    def restore_state(self, snap: dict) -> None:
        """Load a cut into this freshly built service of the same
        configuration."""
        from r2d2_tpu_torch.replay.snapshot import restore_service
        restore_service(self, snap)

    # -- the ring accountant's facade --

    @property
    def buffer_steps(self) -> int:
        return sum(s.ring.buffer_steps for s in self.shards)

    @property
    def total_adds(self) -> int:
        return sum(s.ring.total_adds for s in self.shards)

    @property
    def all_shards_nonempty(self) -> bool:
        """The training gate: sampling an empty tree gives NaN weights."""
        return all(s.ring.total_adds > 0 for s in self.shards)

    def live_versions(self) -> List[int]:
        out: List[int] = []
        for s in self.shards:
            out.extend(s.ring.live_versions())
        return out

    @property
    def live_blocks(self) -> int:
        """Blocks samplable or held in spill: the effective capacity."""
        return sum(s.live_blocks + s.spill.occupancy for s in self.shards)

    @property
    def device_ring_blocks(self) -> int:
        return self.num_shards * self.spec.num_blocks

    @property
    def device_bytes(self) -> int:
        return self.num_shards * self.spec.device_ring_bytes

    # -- telemetry --

    def interval_block(self) -> dict:
        """The record's ``replay_service`` shard, spill and (grouped
        ingest on) ingest sub-blocks in the JAX package's schema; the
        interval counters reset on read."""
        fills = [s.fill for s in self.shards]
        interval = {"demotions": 0, "promotions": 0, "evictions": 0,
                    "thrash_frac": None}
        for s in self.shards:
            iv = s.spill.take_interval()
            for key in ("demotions", "promotions", "evictions"):
                interval[key] += iv[key]
        if interval["demotions"]:
            interval["thrash_frac"] = round(
                interval["evictions"] / interval["demotions"], 4)
        cap = sum(s.spill.capacity for s in self.shards)
        occ = sum(s.spill.occupancy for s in self.shards)
        hits = [s.spill.hit_rate for s in self.shards
                if s.spill.hit_rate is not None]
        spill = {
            "capacity": cap,
            "occupancy": occ,
            "occupancy_frac": (round(occ / cap, 4) if cap else 0.0),
            "hit_rate": (round(float(np.mean(hits)), 4) if hits else None),
            **interval,
        }
        if self.spill_prefetch:
            spill["prefetch"] = True
            spill["prefetch_promotions"] = self._prefetch_iv
            self._prefetch_iv = 0
            spill["spilled_writebacks"] = self.spilled_writebacks
            spill["stale_rows_dropped"] = self.stale_rows_dropped
        if self.tier_stats:
            lats = [s.spill.take_promotion_latency() for s in self.shards]
            lats = [x for x in lats if x is not None]
            merged = None
            if lats:
                merged = {
                    "count": sum(x["count"] for x in lats),
                    "p50_ms": round(float(np.median(
                        [x["p50_ms"] for x in lats])), 3),
                    "p95_ms": round(max(x["p95_ms"] for x in lats), 3),
                    "p99_ms": round(max(x["p99_ms"] for x in lats), 3),
                }
            spill["promotion_latency"] = merged
            page_b = next((s.spill.page_bytes for s in self.shards
                           if s.spill.page_bytes), 0)
            spill["tiers"] = {"device_bytes": self.device_bytes,
                              "spill_bytes": occ * page_b,
                              "spill_page_bytes": page_b}
        out = {
            "shards": {
                "n": self.num_shards,
                "route": self.route,
                "fill": fills,
                "fill_min": min(fills),
                "fill_max": max(fills),
                "adds": [s.ring.total_adds for s in self.shards],
                "live_blocks": [s.live_blocks for s in self.shards],
                "stale_writebacks": self.stale_writebacks,
            },
            "spill": spill,
        }
        if self.ingest_k > 1:
            blocks, dispatches, stage_s, commit_s = self._ingest_iv
            self._ingest_iv = [0, 0, 0.0, 0.0]
            out["ingest"] = {
                "batch_blocks": self.ingest_k,
                "blocks": blocks,
                "dispatches": dispatches,
                "blocks_per_dispatch": (round(blocks / dispatches, 2)
                                        if dispatches else None),
                "stage_ms": round(stage_s * 1e3, 3),
                "commit_ms": round(commit_s * 1e3, 3),
                "backlog": self._backlog,
                "spilled_writebacks": self.spilled_writebacks,
                "stale_rows_dropped": self.stale_rows_dropped,
            }
        return out


# ---------------------------------------------------------------------------
# The socket rung: remote producers route blocks into the service over TCP.


class ReplayServiceServer:
    """TCP listener feeding a ReplayService, one reader thread a producer
    connection. ``("add", fields)`` is acked ``("ack", shard)``;
    ``("addw", seq, inflight, k, stacked_fields)`` commits a group
    through ``add_blocks`` and is acked ``("ackw", seq, k)``
    cumulatively; ``("flushw", seq)`` is always acked. ``drop_ack_every``
    > 0 drops every Nth data ack (the cumulative semantics' drill)."""

    def __init__(self, service: ReplayService, host: str = "127.0.0.1",
                 port: int = 0, drop_ack_every: int = 0, telemetry=None):
        import socket

        from r2d2_tpu_torch.serve.transport import recv_frame, send_frame
        from r2d2_tpu_torch.telemetry.core import NULL_TELEMETRY
        self._recv_frame, self._send_frame = recv_frame, send_frame
        self.service = service
        # a standalone host's Telemetry: commits as spans of its process
        self.telemetry = telemetry or NULL_TELEMETRY
        self.drop_ack_every = int(drop_ack_every)
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.25)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._conns: list = []
        self.blocks_received = 0
        self.acks_dropped = 0
        self._stats_lock = threading.Lock()
        # the interval's frames, blocks, largest in-flight window seen
        # (stamped by the producer) and dropped acks
        self._socket_iv = [0, 0, 0, 0]
        self._data_frames = 0
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="replay-svc-accept")
        self._thread.start()

    def _accept_loop(self) -> None:
        import socket
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(None)
            self._conns.append(conn)
            threading.Thread(target=self._reader_loop, args=(conn,),
                             daemon=True, name="replay-svc-conn").start()

    def _note_frame(self, blocks: int, inflight: int) -> None:
        with self._stats_lock:
            self.blocks_received += blocks
            self._socket_iv[0] += 1
            self._socket_iv[1] += blocks
            self._socket_iv[2] = max(self._socket_iv[2], inflight)

    def _drop_this_ack(self) -> bool:
        if self.drop_ack_every <= 0:
            return False
        with self._stats_lock:
            self._data_frames += 1
            if self._data_frames % self.drop_ack_every == 0:
                self.acks_dropped += 1
                self._socket_iv[3] += 1
                return True
        return False

    def _reader_loop(self, conn) -> None:
        import pickle
        lock = threading.Lock()
        try:
            while not self._stop.is_set():
                frame = self._recv_frame(conn)
                kind = frame[0]
                if kind == "add":
                    _, payload = frame
                    shard = self.service.add_block(
                        block_from_fields(payload))
                    self._note_frame(1, 1)
                    self._send_frame(conn, ("ack", shard), lock)
                elif kind == "addw":
                    _, seq, inflight, k, fields = frame
                    blocks = [block_from_fields({name: v[i] for name, v
                                                 in fields.items()})
                              for i in range(k)]
                    t0 = time.time() if self.telemetry.spans.enabled \
                        else 0.0
                    self.service.add_blocks(blocks)
                    if t0:
                        self.telemetry.record_span(
                            "ingest/commit", t0, time.time(), {"k": k})
                    self._note_frame(k, inflight)
                    if not self._drop_this_ack():
                        self._send_frame(conn, ("ackw", seq, k), lock)
                elif kind == "flushw":
                    _, seq = frame
                    self._send_frame(conn, ("ackw", seq, 0), lock)
        except (ConnectionError, OSError, EOFError, pickle.PickleError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def interval_stats(self) -> dict:
        """The interval's socket gauges (reset on read): the record's
        ``replay_service.socket`` sub-block."""
        with self._stats_lock:
            frames, blocks, window_max, dropped = self._socket_iv
            self._socket_iv = [0, 0, 0, 0]
        return {"frames": frames, "blocks": blocks,
                "window_max": window_max, "acks_dropped": dropped,
                "blocks_total": self.blocks_received}

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
        self._thread.join(timeout=2.0)


class RemoteReplayProducer:
    """A producer's socket channel. ``add_block``: one frame, one blocking
    ack (the routed shard). ``add_blocks`` / ``add_stacked``: one ``addw``
    frame a stacked group, up to ``window`` unacked in flight, cumulative
    acks reaped at the window bound and on ``flush``.

    It dials at construction (a dead address raises there), retrying
    ``connect_retries`` times on the ladder ``min(base * 2^(attempt-1),
    max)``. Each in-flight entry keeps its frame: when the service's
    socket dies the producer redials on the same ladder and replays the
    unacked tail in seq order (a frame the dead service committed is
    written again, a ring overwrite; one it never saw reaches its
    successor). What is lost is what the service committed after its
    last snapshot."""

    def __init__(self, host: str, port: int, dial_timeout: float = 2.0,
                 window: int = 1, connect_retries: int = 0,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 eager_connect: bool = True):
        from r2d2_tpu_torch.serve.transport import recv_frame, send_frame
        self._recv_frame, self._send_frame = recv_frame, send_frame
        self._addr = (host, port)
        self._dial_timeout = dial_timeout
        self.window = max(int(window), 1)
        self.connect_retries = max(int(connect_retries), 0)
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._sock = None
        self._lock = threading.Lock()
        self._seq = 0
        # (seq, blocks, frame): the frame kept for a tail replay; None for
        # a flush probe (connection-local, dropped at a reconnect)
        self._inflight: "deque[Tuple[int, int, Optional[tuple]]]" = deque()
        self.frames_sent = 0
        self.blocks_acked = 0
        self.reconnects = 0
        self.blocks_resent = 0
        if eager_connect:
            self._ensure()

    def _dial(self):
        import socket
        attempt = 0
        while True:
            try:
                s = socket.create_connection(self._addr,
                                             timeout=self._dial_timeout)
                break
            except OSError:
                attempt += 1
                if attempt > self.connect_retries:
                    raise
                time.sleep(min(self.backoff_base_s * (2 ** (attempt - 1)),
                               self.backoff_max_s))
        # large frames one way, small acks the other: Nagle would hold an
        # ack behind the peer's delayed ACK
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(self._dial_timeout)
        return s

    def _ensure(self):
        if self._sock is None:
            self._sock = self._dial()
        return self._sock

    def _drop_socket(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _recover(self, timeout: float):
        """Redial and replay the unacked tail in seq order, flush probes
        dropped first (the old connection's resync points)."""
        self._drop_socket()
        sock = self._ensure()
        sock.settimeout(timeout)
        self.reconnects += 1
        self._inflight = deque(e for e in self._inflight
                               if e[2] is not None)
        for _seq, k, frame in list(self._inflight):
            self._send_frame(sock, frame, self._lock)
            self.blocks_resent += k
        return sock

    def add_block(self, block: Block, timeout: float = 5.0) -> int:
        frame = ("add", _block_fields(block))
        try:
            sock = self._ensure()
            sock.settimeout(timeout)
            self._send_frame(sock, frame, self._lock)
            kind, shard = self._recv_frame(sock)
        except (ConnectionError, EOFError, OSError):
            # nothing windowed is outstanding on the lockstep rung (a tail
            # replays first): this one frame again
            sock = self._recover(timeout)
            self._send_frame(sock, frame, self._lock)
            kind, shard = self._recv_frame(sock)
        if kind != "ack":
            raise ConnectionError(f"unexpected reply kind {kind!r}")
        return int(shard)

    def add_blocks(self, blocks: List[Block], timeout: float = 5.0) -> None:
        """Ship a group of blocks as one windowed frame."""
        if not blocks:
            return
        per = [_block_fields(b) for b in blocks]
        fields = {name: np.stack([p[name] for p in per])
                  for name in per[0] if all(name in p for p in per)}
        self._send_windowed(fields, len(blocks), timeout)

    def add_stacked(self, stacked: Block, k: int,
                    timeout: float = 5.0) -> None:
        """Ship an already stacked group (a leading K axis on every field:
        ``BlockQueue.drain_stacked``'s layout)."""
        if k <= 0:
            return
        self._send_windowed(_block_fields(stacked), k, timeout)

    def _send_windowed(self, fields, k: int, timeout: float) -> None:
        self._seq += 1
        frame = ("addw", self._seq, len(self._inflight), k, fields)
        self._inflight.append((self._seq, k, frame))
        self.frames_sent += 1
        try:
            sock = self._ensure()
            sock.settimeout(timeout)
            self._send_frame(sock, frame, self._lock)
        except (ConnectionError, EOFError, OSError):
            sock = self._recover(timeout)   # replays the tail, this frame too
        while len(self._inflight) >= self.window:
            self._await_ack(sock, timeout)

    def _await_ack(self, sock, timeout: float = 5.0) -> None:
        """Reap one cumulative ack. A receive timeout sends one flush probe
        (always acked), so a window stalled behind a dropped last ack
        heals; a dead socket recovers through the tail replay."""
        import socket as _socket
        if self._sock is not None:
            # an earlier reap's recovery replaced the caller's socket
            sock = self._sock
        try:
            try:
                frame = self._recv_frame(sock)
            except _socket.timeout:
                self._seq += 1
                self._send_frame(sock, ("flushw", self._seq), self._lock)
                self._inflight.append((self._seq, 0, None))
                frame = self._recv_frame(sock)
        except (ConnectionError, EOFError, OSError):
            sock = self._recover(timeout)
            if not self._inflight:
                return
            self._seq += 1
            self._send_frame(sock, ("flushw", self._seq), self._lock)
            self._inflight.append((self._seq, 0, None))
            frame = self._recv_frame(sock)
        kind, seq, _k = frame
        if kind != "ackw":
            raise ConnectionError(f"unexpected reply kind {kind!r}")
        while self._inflight and self._inflight[0][0] <= seq:
            _, nblocks, _frame = self._inflight.popleft()
            self.blocks_acked += nblocks

    def flush(self, timeout: float = 5.0) -> int:
        """Drain the window: one always-acked flush frame, then reap until
        empty. The cumulative blocks acked."""
        if self._sock is not None or self._inflight:
            try:
                sock = self._ensure()
                sock.settimeout(timeout)
                self._seq += 1
                self._send_frame(sock, ("flushw", self._seq), self._lock)
                self._inflight.append((self._seq, 0, None))
            except (ConnectionError, EOFError, OSError):
                sock = self._recover(timeout)
                if self._inflight:
                    self._seq += 1
                    self._send_frame(sock, ("flushw", self._seq),
                                     self._lock)
                    self._inflight.append((self._seq, 0, None))
            while self._inflight:
                self._await_ack(sock, timeout)
        return self.blocks_acked

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def close(self) -> None:
        self._drop_socket()
        self._inflight.clear()


class ReplayProducerPump:
    """A producer host's emit pump: drains a BlockQueue in stacked groups
    (``drain_stacked``) and ships each as one windowed frame through a
    ``RemoteReplayProducer``; the actors emit into the queue as they
    would for a local learner."""

    def __init__(self, queue, producer: RemoteReplayProducer,
                 group: int = 8, idle_sleep_s: float = 0.002):
        self.queue = queue
        self.producer = producer
        self.group = max(int(group), 1)
        self.idle_sleep_s = idle_sleep_s
        self.blocks_sent = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def pump_once(self) -> int:
        """Drain up to one group and ship it; the blocks shipped."""
        stacked, k = self.queue.drain_stacked(self.group)
        if k == 0:
            return 0
        if k == 1 and self.producer.window <= 1:
            # the lockstep rung's cadence
            fields = {name: v[0] for name, v in _block_fields(stacked).items()}
            self.producer.add_block(block_from_fields(fields))
        else:
            self.producer.add_stacked(stacked, k)
        self.blocks_sent += k
        return k

    def run(self, stop: Optional[threading.Event] = None,
            seconds: Optional[float] = None) -> int:
        """Pump until ``stop`` is set and the queue drained, or
        ``seconds`` elapse; flushes the window; the blocks shipped."""
        stop = stop or self._stop
        deadline = (time.monotonic() + seconds) if seconds else None
        while True:
            n = self.pump_once()
            if deadline is not None and time.monotonic() >= deadline:
                break
            if n == 0:
                if stop.is_set():
                    break
                time.sleep(self.idle_sleep_s)
        self.producer.flush()
        return self.blocks_sent

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="replay-producer-pump")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def build_service(cfg, device, tier_stats: Optional[bool] = None
                  ) -> ReplayService:
    """The service the learner and the standalone host build from a
    config: ``fleet.replay_shards`` equal slices of the device ring on
    ``device``, the replay diagnostics' ring state off (the service's
    block carries the shards' health)."""
    spec = ReplaySpec.from_config(cfg, device)
    shard_spec = dataclasses.replace(
        spec, num_blocks=spec.num_blocks // cfg.fleet.replay_shards,
        replay_diag=False)
    if tier_stats is None:
        tier_stats = (cfg.telemetry.enabled
                      and cfg.telemetry.replay_tiers_enabled)
    fl = cfg.fleet
    return ReplayService(shard_spec, fl.replay_shards, device,
                         spill_blocks=fl.spill_blocks,
                         route=fl.replay_route,
                         promote_per_sample=fl.spill_promote_per_sample,
                         ingest_batch_blocks=fl.ingest_batch_blocks,
                         spill_prefetch=fl.spill_prefetch,
                         tier_stats=tier_stats)


__all__ = ["SpillTier", "ReplayShard", "ReplayService",
           "ReplayServiceServer", "RemoteReplayProducer",
           "ReplayProducerPump", "build_service", "block_from_fields",
           "ROUTES"]
