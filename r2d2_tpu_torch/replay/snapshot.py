"""Durable replay snapshots, the plain (single replay) path of the JAX
package's ``replay/snapshot.py``.

The replay is the expensive state of an R2D2 run: the weights come back
from any checkpoint in seconds, the ring took millions of env steps to
fill. A snapshot holds every ``ReplayState`` leaf (storage rings, sum
tree, ring pointer, weight-version and lane stamps, and with the replay
diagnostics on their sample counts, birth stamps, add counter and
eviction ledger; a leaf that is None, the diagnostics off, is captured as
absent and restored as None, as the JAX package's snapshot contract
says), the host's
``RingAccountant`` mirror and the caller's extras (the learner's env-step
counter and its sampling generator's state), and restores them bit for
bit into a freshly built replay of the same geometry.

The cut: ``capture_plain`` runs between learner dispatches, the point
where blocks commit, so a snapshot never splits a ring write. On the card
every leaf is copied into pinned host memory on the current stream (the
learner's) without a host sync, and an event marks the copies' end; the
writer thread waits on that event before it serializes, so the train loop
pays only the launch of the copies. The copies queue behind the
dispatches already issued, so the cut is the state those dispatches
leave.

Disk format: one ``.npz`` payload and one ``.json`` manifest a player,
each written to a temporary name and renamed into place; the manifest's
rename is the commit point. A loader that finds a manifest whose payload
size matches reads a complete snapshot; a crash mid-write leaves the
previous pair. ``SnapshotWriter`` serializes on a background thread, the
newest submitted cut winning.

A data-parallel replay (parallel/sharded.py: one shard a dp row) is cut
in the JAX package's layout for its mesh: one entry whose leaves stack
the shards' on a leading dp axis, in dp order (``block_ptr`` becomes a
(dp,) leaf), beside the RingAccountant over every shard
(``capture_sharded``); each rank restores its own index
(``restore_plain(..., shard=)``).

The replay service (fleet/replay_service.py) is cut whole under its lock
(``capture_service``): per shard its state's leaves (copied on the
service's stream), its RingAccountant, its spill tier's pages in LRU
order with their stored priorities (the heap is rebuilt from them on
restore), its resident pages and demotion table, and the service's route
and round-robin cursors, in the JAX package's layout; ``restore_service``
loads it bit for bit into a freshly built service of the same
configuration. The caller's extras carry the learner's service sampling
generator's state where the JAX package carries its ``service_key``.
"""

import heapq
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from r2d2_tpu_torch.replay.structs import DIAG_LEAVES

SNAPSHOT_VERSION = 1

# ReplaySpec fields a snapshot must agree on to be loadable: everything
# that shapes the state tensors or the sampling
_SPEC_FIELDS = ("num_blocks", "seqs_per_block", "block_length", "burn_in",
                "learning", "forward", "frame_stack", "frame_height",
                "frame_width", "hidden_dim", "batch_size", "prio_exponent",
                "is_exponent", "exact_gather", "replay_diag")

# ReplayState's leaves, in JAX's order; block_ptr is a host int here and
# a () int32 leaf in the file, as JAX stores it
_LEAVES = ("tree", "obs", "last_action", "hidden", "action", "reward",
           "gamma", "burn_in_steps", "learning_steps", "forward_steps",
           "seq_start", "weight_version", "block_ptr", "lane")


def _present(state) -> tuple:
    """The leaves ``state`` holds: every one of ``_LEAVES`` and the
    replay diagnostics' that are not None (``spec.replay_diag``)."""
    return _LEAVES + tuple(name for name in DIAG_LEAVES
                           if getattr(state, name, None) is not None)


def snapshot_paths(save_dir: str, player_idx: int):
    """(payload, manifest) paths of one player's rolling snapshot."""
    base = os.path.join(save_dir, f"replay_player{player_idx}")
    return base + ".npz", base + ".json"


def _spec_fingerprint(spec) -> dict:
    return {f: getattr(spec, f) for f in _SPEC_FIELDS}


def _check_spec(snap: dict, spec) -> None:
    got, want = snap["spec"], _spec_fingerprint(spec)
    if got != want:
        diff = {k: (got.get(k), want[k]) for k in want
                if got.get(k) != want[k]}
        raise ValueError(
            f"replay snapshot spec mismatch {diff} (snapshot, current) — "
            "the snapshot belongs to a different replay geometry")


def _state_to_host(state) -> dict:
    """ReplayState -> {leaf: host tensor or array}. A CUDA leaf is copied
    into new pinned memory without blocking the host (``wait_ready``
    before reading it); a CPU leaf is cloned."""
    out = {}
    for name in _present(state):
        leaf = getattr(state, name)
        if name == "block_ptr":
            out[name] = np.asarray(int(leaf), np.int32)
        elif leaf.is_cuda:
            host = torch.empty(leaf.shape, dtype=leaf.dtype,
                               pin_memory=True)
            host.copy_(leaf, non_blocking=True)
            out[name] = host
        else:
            out[name] = leaf.detach().clone()
    return out


def _capture_ring(ring) -> dict:
    cap = {
        "ptr": int(ring.ptr),
        "total_adds": int(ring.total_adds),
        "buffer_steps": int(ring.buffer_steps),
        "slot_steps": [int(s) for s in ring.slot_steps],
        "slot_versions": [int(v) for v in ring.slot_versions],
    }
    # the lineage mirrors ride only when something is traced: an
    # untraced run's snapshot is what it is without tracing, and one
    # without them restores as untraced
    if any(t >= 0 for t in ring.slot_trace):
        cap["slot_trace"] = [int(t) for t in ring.slot_trace]
        cap["slot_ingest"] = [int(t) for t in ring.slot_ingest_ms]
    return cap


def capture_plain(spec, state, ring, step: int,
                  extra: Optional[dict] = None) -> dict:
    """A cut of one device replay and its RingAccountant mirror, taken
    between dispatches. ``extra``: JSON-serializable caller state that
    rides the snapshot. On the card the leaves are still being copied
    when this returns: ``wait_ready`` (``write_snapshot`` calls it) waits
    for the copies."""
    leaves = _state_to_host(state)
    ready = None
    if state.obs.is_cuda:
        ready = torch.cuda.Event()
        ready.record()
    return {
        "version": SNAPSHOT_VERSION,
        "kind": "plain",
        "step": int(step),
        "spec": _spec_fingerprint(spec),
        "extra": dict(extra or {}),
        "shards": [{"state": leaves, "ring": _capture_ring(ring)}],
        "ready": ready,
    }


def _capture_shard(shard) -> dict:
    """One service shard's cut (``capture_service``): its state's leaves
    (still copying on the card), ring, spill pages in LRU order, resident
    pages and demotion table. A page's arrays are never written in place
    (a write-back replaces its priority array), so the cut holds them."""
    from r2d2_tpu_torch.fleet.replay_service import _block_fields
    spill = shard.spill
    pages = [(int(pid), _block_fields(block), int(learning), int(wv))
             for pid, (block, learning, wv) in spill._pages.items()]
    resident = [(slot, _block_fields(blk), int(learning), int(wv))
                for slot, page in enumerate(shard._resident)
                if page is not None
                for blk, learning, wv in [page]]
    return {
        "state": _state_to_host(shard.state),
        "ring": _capture_ring(shard.ring),
        "spill": {
            "next_id": int(spill._next_id),
            "demotions": int(spill.demotions),
            "promotions": int(spill.promotions),
            "evictions": int(spill.evictions),
            "writebacks": int(spill.writebacks),
            "pages": pages,
        },
        "resident": resident,
        "demote_ids": [(-1 if d is None else int(d))
                       for d in shard._demote_ids],
    }


def capture_service(service, step: int, extra: Optional[dict] = None) -> dict:
    """A cut of a whole ReplayService under its lock, taken between
    commits. On the card the leaves copy on the service's stream and
    ``wait_ready`` waits for them. ``extra``: JSON-serializable caller
    state (the learner's service generator state)."""
    with service._lock, service.on_stream():
        shards = [_capture_shard(s) for s in service.shards]
        ready = None
        if service.stream is not None:
            ready = torch.cuda.Event()
            ready.record(service.stream)
        return {
            "version": SNAPSHOT_VERSION,
            "kind": "service",
            "step": int(step),
            "spec": _spec_fingerprint(service.spec),
            "route": service.route,
            "rr_add": int(service._rr_add),
            "rr_sample": int(service._rr_sample),
            "extra": dict(extra or {}),
            "shards": shards,
            "ready": ready,
        }


def cut_digest(snap: dict) -> str:
    """sha256 of a service cut whose leaves are host arrays
    (``wait_ready``'s or ``load_snapshot``'s): every shard's state
    leaves, ring, spill pages (ids, order, fields) and demotion table,
    and the cursors; equal digests, equal cuts."""
    import hashlib
    h = hashlib.sha256()

    def put(x) -> None:
        a = np.ascontiguousarray(np.asarray(x))
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())

    for key in ("route", "rr_add", "rr_sample"):
        h.update(repr(snap.get(key)).encode())
    for shard in snap["shards"]:
        for name in sorted(shard["state"]):
            put(shard["state"][name])
        ring = shard["ring"]
        for key in ("ptr", "total_adds", "buffer_steps", "slot_steps",
                    "slot_versions"):
            put(ring[key])
        for key in ("pages", "resident"):
            pages = (shard["spill"]["pages"] if key == "pages"
                     else shard[key])
            for pid, fields, learning, wv in pages:
                put([pid, learning, wv])
                for name in sorted(fields):
                    put(fields[name])
        put(shard["demote_ids"])
    return h.hexdigest()


def shard_leaves(state) -> dict:
    """One replay shard's leaves as host numpy arrays, its copies waited
    for: a data-parallel rank's part of ``capture_sharded``."""
    leaves = _state_to_host(state)
    if state.obs.is_cuda:
        torch.cuda.current_stream(state.obs.device).synchronize()
    return {name: (leaf.numpy() if torch.is_tensor(leaf)
                   else np.asarray(leaf)) for name, leaf in leaves.items()}


def capture_sharded(spec, shards: list, ring, step: int,
                    extra: Optional[dict] = None) -> dict:
    """A cut of a dp-sharded replay from every shard's ``shard_leaves``, in
    dp order, and the RingAccountant over all of them: the leaves stacked
    on a leading dp axis, as the JAX package captures its mesh's
    replay."""
    return {
        "version": SNAPSHOT_VERSION,
        "kind": "plain",
        "step": int(step),
        "spec": _spec_fingerprint(spec),
        "extra": dict(extra or {}),
        "shards": [{"state": {name: np.stack([s[name] for s in shards])
                              for name in shards[0]},
                    "ring": _capture_ring(ring)}],
        "ready": None,
    }


def wait_ready(snap: dict) -> dict:
    """Wait for a capture's copies to land, then hold its leaves as numpy
    arrays (views of the host tensors). Returns ``snap``."""
    ready = snap.pop("ready", None)
    if ready is not None:
        ready.synchronize()
    for shard in snap["shards"]:
        shard["state"] = {name: (leaf.numpy() if torch.is_tensor(leaf)
                                 else np.asarray(leaf))
                          for name, leaf in shard["state"].items()}
    return snap


def _restore_ring(ring, cap: dict) -> None:
    ring.ptr = int(cap["ptr"])
    ring.total_adds = int(cap["total_adds"])
    ring.buffer_steps = int(cap["buffer_steps"])
    ring.slot_steps = [int(s) for s in cap["slot_steps"]]
    ring.slot_versions = [int(v) for v in cap["slot_versions"]]
    n = len(ring.slot_steps)
    ring.slot_trace = [int(t) for t in cap.get("slot_trace", [-1] * n)]
    ring.slot_ingest_ms = [int(t) for t in cap.get("slot_ingest", [-1] * n)]


def _restore_spill(spill, cap: dict) -> None:
    from r2d2_tpu_torch.fleet.replay_service import block_from_fields
    spill._pages = OrderedDict()
    spill._prio = {}
    spill._heap = []
    spill._demoted_at = {}
    for pid, fields, learning, wv in cap["pages"]:
        block = block_from_fields(fields)
        spill._pages[int(pid)] = (block, int(learning), int(wv))
        prio = float(np.max(np.asarray(block.priority)))
        spill._prio[int(pid)] = prio
        spill._heap.append((-prio, int(pid)))
    heapq.heapify(spill._heap)
    spill._next_id = int(cap["next_id"])
    spill.demotions = int(cap["demotions"])
    spill.promotions = int(cap["promotions"])
    spill.evictions = int(cap["evictions"])
    spill.writebacks = int(cap["writebacks"])


def _copy_leaves(state, leaves: dict) -> None:
    """Copy a cut's leaves into ``state``'s tensors (their addresses
    stay); ``block_ptr`` is set from its leaf."""
    names = _present(state)
    if set(leaves) != set(names):
        raise ValueError(f"replay snapshot leaf set {sorted(leaves)} != "
                         f"expected {sorted(names)}")
    with torch.no_grad():
        for name in names:
            if name == "block_ptr":
                continue
            dst = getattr(state, name)
            src = torch.as_tensor(np.asarray(leaves[name]))
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(
                    f"replay snapshot leaf {name}: {tuple(src.shape)} "
                    f"{src.dtype}, the replay holds {tuple(dst.shape)} "
                    f"{dst.dtype}")
            dst.copy_(src)
    state.block_ptr = int(np.asarray(leaves["block_ptr"]))


def restore_service(service, snap: dict) -> None:
    """Load a service cut into a freshly built ReplayService of the same
    configuration: the shards' tensors copied in place on the service's
    stream, the accountants, spill tiers, resident pages, demotion tables
    and cursors overwritten."""
    from r2d2_tpu_torch.fleet.replay_service import block_from_fields
    if snap.get("kind") != "service":
        raise ValueError(f"snapshot kind {snap.get('kind')!r} is not a "
                         "service snapshot")
    _check_spec(snap, service.spec)
    if len(snap["shards"]) != service.num_shards:
        raise ValueError(
            f"snapshot has {len(snap['shards'])} shards, service has "
            f"{service.num_shards} — shard count must match to restore")
    if snap["route"] != service.route:
        raise ValueError(
            f"snapshot route {snap['route']!r} != service route "
            f"{service.route!r}")
    wait_ready(snap)
    with service._lock, service.on_stream():
        for shard, cap in zip(service.shards, snap["shards"]):
            _copy_leaves(shard.state, cap["state"])
            _restore_ring(shard.ring, cap["ring"])
            _restore_spill(shard.spill, cap["spill"])
            shard._resident = [None] * shard.spec.num_blocks
            for slot, fields, learning, wv in cap["resident"]:
                shard._resident[int(slot)] = (
                    block_from_fields(fields), int(learning), int(wv))
            shard._demote_ids = [(None if d < 0 else int(d))
                                 for d in cap["demote_ids"]]
        service._rr_add = int(snap["rr_add"])
        service._rr_sample = int(snap["rr_sample"])


def restore_plain(spec, state, ring, snap: dict,
                  shard: Optional[int] = None, dp: Optional[int] = None):
    """Load a plain cut into ``state`` (copied into its tensors, whose
    addresses stay) and ``ring`` (overwritten); returns ``state``. A cut
    of a ``dp``-sharded replay (``capture_sharded``) loads its shard
    ``shard``."""
    if snap.get("kind") != "plain":
        raise ValueError(f"snapshot kind {snap.get('kind')!r} is not a "
                         "plain replay snapshot")
    _check_spec(snap, spec)
    leaves = snap["shards"][0]["state"]
    names = _present(state)
    if set(leaves) != set(names):
        raise ValueError(f"replay snapshot leaf set {sorted(leaves)} != "
                         f"expected {sorted(names)}")
    got, want = np.shape(leaves["block_ptr"]), (() if shard is None
                                                else (dp,))
    if got != want:
        raise ValueError(
            f"the replay snapshot's block_ptr has shape {got}, this "
            f"learner's replay {want}: a snapshot restores into a replay "
            "of the same mesh dp")
    if shard is not None:
        leaves = {name: np.asarray(leaf)[shard]
                  for name, leaf in leaves.items()}
    _copy_leaves(state, leaves)
    _restore_ring(ring, snap["shards"][0]["ring"])
    return state


def _flatten_payload(snap: dict) -> dict:
    """Every array goes into the npz; scalars and structure stay in the
    manifest."""
    arrays = {}
    for j, shard in enumerate(snap["shards"]):
        p = f"s{j}."
        for name, arr in shard["state"].items():
            arrays[p + "state." + name] = arr
        arrays[p + "ring.slot_steps"] = np.asarray(
            shard["ring"]["slot_steps"], np.int64)
        arrays[p + "ring.slot_versions"] = np.asarray(
            shard["ring"]["slot_versions"], np.int64)
        for name in ("slot_trace", "slot_ingest"):
            if name in shard["ring"]:
                arrays[p + "ring." + name] = np.asarray(shard["ring"][name],
                                                        np.int64)
        if "spill" in shard:
            _flatten_pages(arrays, p + "spill.", "ids",
                           shard["spill"]["pages"])
            _flatten_pages(arrays, p + "res.", "slots", shard["resident"])
            arrays[p + "demote_ids"] = np.asarray(shard["demote_ids"],
                                                  np.int64)
    return arrays


def _common_fields(pages) -> list:
    """The page fields present on every page, in the first page's order
    (a page without a lineage stamp among stamped ones: the stamp is
    dropped, the page restores untraced)."""
    if not pages:
        return []
    common = set(pages[0][1])
    for _, fields, _, _ in pages[1:]:
        common &= set(fields)
    return [f for f in pages[0][1] if f in common]


def _flatten_pages(arrays: dict, prefix: str, ids_key: str, pages) -> None:
    """(id, fields, learning, version) pages as stacked arrays: the JAX
    package's spill-page layout."""
    arrays[prefix + ids_key] = np.asarray([i for i, _, _, _ in pages],
                                          np.int64)
    arrays[prefix + "learning"] = np.asarray([lg for _, _, lg, _ in pages],
                                             np.int64)
    arrays[prefix + "wv"] = np.asarray([wv for _, _, _, wv in pages],
                                       np.int64)
    for field in _common_fields(pages):
        arrays[prefix + "f." + field] = np.stack(
            [fields[field] for _, fields, _, _ in pages])


def _unstack_pages(data, prefix: str, ids_key: str) -> list:
    ids = data[prefix + ids_key]
    learning = data[prefix + "learning"]
    wv = data[prefix + "wv"]
    fields = {k[len(prefix) + 2:]: data[k] for k in data.files
              if k.startswith(prefix + "f.")}
    return [(int(ids[i]), {f: arr[i] for f, arr in fields.items()},
             int(learning[i]), int(wv[i])) for i in range(ids.shape[0])]


def _manifest_meta(snap: dict, payload_name: str, payload_bytes: int,
                   duration_s: float) -> dict:
    meta = {
        "version": snap["version"],
        "kind": snap["kind"],
        "step": snap["step"],
        "spec": snap["spec"],
        "extra": snap["extra"],
        "payload": payload_name,
        "payload_bytes": payload_bytes,
        "written_at": time.time(),
        "write_s": round(duration_s, 6),
        "total_adds": sum(s["ring"]["total_adds"] for s in snap["shards"]),
        "shards": [],
    }
    if snap["kind"] == "service":
        meta.update(route=snap["route"], rr_add=snap["rr_add"],
                    rr_sample=snap["rr_sample"])
    for shard in snap["shards"]:
        entry = {"state_leaves": sorted(shard["state"]),
                 "ring": {k: shard["ring"][k]
                          for k in ("ptr", "total_adds", "buffer_steps")}}
        if "spill" in shard:
            entry["spill"] = {k: shard["spill"][k] for k in _SPILL_COUNTS}
            entry["spill"]["occupancy"] = len(shard["spill"]["pages"])
        meta["shards"].append(entry)
    return meta


_SPILL_COUNTS = ("next_id", "demotions", "promotions", "evictions",
                 "writebacks")


def write_snapshot(snap: dict, save_dir: str, player_idx: int) -> dict:
    """Persist one snapshot atomically: the payload, then the manifest,
    whose rename commits. Returns the manifest (bytes, seconds, step,
    written_at)."""
    os.makedirs(save_dir, exist_ok=True)
    payload_path, manifest_path = snapshot_paths(save_dir, player_idx)
    t0 = time.perf_counter()
    wait_ready(snap)
    arrays = _flatten_payload(snap)
    tmp = payload_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, payload_path)
    payload_bytes = os.path.getsize(payload_path)
    meta = _manifest_meta(snap, os.path.basename(payload_path),
                          payload_bytes, time.perf_counter() - t0)
    tmp = manifest_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, manifest_path)
    return meta


def _read_meta(manifest_path: str) -> Optional[dict]:
    try:
        with open(manifest_path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return None


def _payload_matches(payload_path: str, meta: dict) -> bool:
    return (os.path.exists(payload_path)
            and os.path.getsize(payload_path) == meta.get("payload_bytes"))


def load_snapshot(save_dir: str, player_idx: int) -> Optional[dict]:
    """A committed snapshot in ``capture_plain``'s shape (numpy leaves);
    None when there is none, or when the payload is missing or its size
    disagrees with the manifest (a torn write: nothing consistent is
    left)."""
    payload_path, manifest_path = snapshot_paths(save_dir, player_idx)
    if not os.path.exists(manifest_path):
        return None
    with open(manifest_path) as f:
        meta = json.load(f)
    if meta.get("version") != SNAPSHOT_VERSION:
        raise ValueError(
            f"replay snapshot version {meta.get('version')} != "
            f"{SNAPSHOT_VERSION} at {manifest_path}")
    if not _payload_matches(payload_path, meta):
        return None
    snap = {key: meta[key] for key in ("version", "kind", "step", "spec")}
    snap["extra"] = meta.get("extra", {})
    snap["shards"] = []
    if meta["kind"] == "service":
        snap.update(route=meta["route"], rr_add=meta["rr_add"],
                    rr_sample=meta["rr_sample"])
    with np.load(payload_path) as data:
        for j, entry in enumerate(meta["shards"]):
            p = f"s{j}."
            shard = {
                "state": {name: data[p + "state." + name]
                          for name in entry["state_leaves"]},
                "ring": {
                    **entry["ring"],
                    "slot_steps": data[p + "ring.slot_steps"].tolist(),
                    "slot_versions":
                        data[p + "ring.slot_versions"].tolist(),
                    **{name: data[p + "ring." + name].tolist()
                       for name in ("slot_trace", "slot_ingest")
                       if p + "ring." + name in data.files},
                },
            }
            if "spill" in entry:
                shard["spill"] = {
                    **{k: entry["spill"][k] for k in _SPILL_COUNTS},
                    "pages": _unstack_pages(data, p + "spill.", "ids")}
                shard["resident"] = _unstack_pages(data, p + "res.", "slots")
                shard["demote_ids"] = data[p + "demote_ids"].tolist()
            snap["shards"].append(shard)
    return snap


def read_manifest(save_dir: str, player_idx: int) -> Optional[dict]:
    """The manifest alone, without loading the payload: the cheap probe.
    None as for ``load_snapshot``."""
    payload_path, manifest_path = snapshot_paths(save_dir, player_idx)
    if not os.path.exists(manifest_path):
        return None
    meta = _read_meta(manifest_path)
    if meta is None or not _payload_matches(payload_path, meta):
        return None
    return meta


class SnapshotWriter:
    """Writes submitted cuts on a background thread. Latest wins: a cut
    submitted while another waits replaces it (counted in ``dropped``).
    A failed write is raised at the next ``submit``, so a run whose
    snapshots cannot land fails instead of pretending durability."""

    def __init__(self, save_dir: str, player_idx: int):
        self.save_dir = save_dir
        self.player_idx = player_idx
        self._pending: Optional[dict] = None
        self._writing = False
        self._cond = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # read by the recovery block; guarded by _cond
        self.count = 0
        self.dropped = 0
        self.last_meta: Optional[dict] = None

    def _raise_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, snap: dict) -> None:
        """Queue one cut for writing, starting the thread on first use."""
        with self._cond:
            self._raise_error()
            if self._pending is not None:
                self.dropped += 1
            self._pending = snap
            if self._thread is None:
                self._stop = False
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"replay-snapshot-p{self.player_idx}")
                self._thread.start()
            self._cond.notify_all()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._stop:
                    self._cond.wait(timeout=0.25)
                if self._pending is None:
                    return
                snap, self._pending = self._pending, None
                self._writing = True
            try:
                meta = write_snapshot(snap, self.save_dir, self.player_idx)
            except BaseException as e:      # raised at the next submit
                with self._cond:
                    self._error = e
                    self._writing = False
                    self._cond.notify_all()
                continue
            with self._cond:
                self.count += 1
                self.last_meta = meta
                self._writing = False
                self._cond.notify_all()

    def write_now(self, snap: dict) -> dict:
        """Write synchronously (a clean stop: the process is about to
        exit). A cut still waiting is replaced by this newer one."""
        with self._cond:
            self._raise_error()
            if self._pending is not None:
                self._pending = None
                self.dropped += 1
            while self._writing:
                self._cond.wait(timeout=0.25)
        meta = write_snapshot(snap, self.save_dir, self.player_idx)
        with self._cond:
            self.count += 1
            self.last_meta = meta
        return meta

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until no cut is waiting or being written; False on
        timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._pending is not None or self._writing:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=min(left, 0.25))
        return True

    def check(self) -> None:
        """Raise a failed write now."""
        with self._cond:
            self._raise_error()

    def stop(self, join_timeout: float = 10.0) -> None:
        """Write what is waiting, then end the thread (idempotent)."""
        self.drain(join_timeout)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            self._thread = None
