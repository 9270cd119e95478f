"""Shared small utilities: the atomic, merging JSON caches.

``load_json_cache`` / ``store_json_cache`` back the AnnealEngine autotune
cache (``core/engine.py``) and, in their 16-way sharded layout, the
best-known oracle cache (``api/oracle.py``). Loads tolerate missing files
and quarantine corrupt ones (renamed to ``<path>.corrupt``). Stores re-read
the file under an advisory ``flock``, union-merge with the writer's view
(per-key conflicts go to ``resolve(old, new)``) and replace it atomically.
Stores are best-effort: a cache is an optimization, so persistence
failures never fail a solve.

The sharded layout keeps a cache logically at ``<stem>.json`` as
``<stem>.shards/shard-<x>.json``, ``x`` the first hex nibble of each key's
trailing content hash; a monolithic file found at the logical path is
migrated into the shards once.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
from typing import Callable, Iterable, Optional

try:
    import fcntl
except ImportError:                      # non-POSIX: fall back to lockless
    fcntl = None                         # (atomic rename still holds)


@contextlib.contextmanager
def _store_lock(path: str):
    """Advisory cross-process lock serializing read-merge-replace cycles
    on ``path``. Best-effort: yields unlocked when flock is unavailable."""
    if fcntl is None:
        yield
        return
    fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)                     # closing releases the flock


def load_json_cache(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except OSError:
        return {}
    except ValueError:
        # corrupt / truncated (e.g. a killed writer before the atomic-store
        # change, or manual editing): move it aside instead of crashing or
        # silently shadowing it forever.
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass
        return {}


def store_json_cache(path: str, cache: dict,
                     resolve: Optional[Callable] = None,
                     drop=()) -> None:
    """Merge ``cache`` into the file at ``path`` atomically.

    Keys present only on disk survive (another writer's entries are never
    clobbered); keys present in both go to ``resolve(disk_value, value)``
    — default: the caller's value wins (fresh computation beats stale).

    ``drop`` names keys whose ON-DISK value must not survive the merge —
    the serve tier's corrupt-result quarantine: a validated-bad entry is
    evicted from memory, but a plain merge would resurrect it from disk
    (and ``resolve`` could even prefer it, e.g. a corrupt high-budget entry
    beating its clean low-budget replacement). Dropped keys are removed
    from the disk view before merging, so a replacement in ``cache`` lands
    without a conflict and a key with no replacement disappears.
    """
    try:
        parent = os.path.dirname(path)
        if parent:                       # bare filenames have no dir to make
            os.makedirs(parent, exist_ok=True)
        with _store_lock(path):
            disk = load_json_cache(path)
            for key in drop:
                disk.pop(key, None)
            merged = dict(disk)
            for key, val in cache.items():
                if resolve is not None and key in disk:
                    val = resolve(disk[key], val)
                merged[key] = val
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(merged, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
    except OSError:
        pass


# --------------------------------------------------------------------------
# Sharded stores: 16 shards keyed by content-hash prefix.
# --------------------------------------------------------------------------

CACHE_SHARDS = 16

_HEX = "0123456789abcdef"


def shard_of(key: str) -> int:
    """Shard index (0..15) for a cache key.

    Keys in this repo end in a ``:``-separated hex content hash
    (``{solver}:{runs}:{seed}:{cfg}:{content_hash}`` for serve results,
    bare ``{content_hash}`` for the oracle), so the first hex nibble of
    the trailing component spreads keys uniformly. Keys that don't look
    like that (autotune keys, hand-written tests) fall back to sha1 of
    the whole key — still deterministic, still uniform.
    """
    tail = key.rsplit(":", 1)[-1]
    if tail and tail[0] in _HEX:
        return int(tail[0], 16)
    digest = hashlib.sha1(key.encode()).hexdigest()
    return int(digest[0], 16)


def shard_paths(path: str) -> list:
    """The 16 shard files backing a cache logically at ``path``.

    ``experiments/oracle_cache_torch.json`` →
    ``experiments/oracle_cache_torch.shards/shard-<x>.json``.
    """
    stem = path[:-5] if path.endswith(".json") else path
    return [os.path.join(f"{stem}.shards", f"shard-{_HEX[i]}.json")
            for i in range(CACHE_SHARDS)]


def _migrate_monolith(path: str) -> None:
    """One-time transparent migration of a legacy monolithic cache file
    into the shard directory. The monolith's entries are merged into
    their shards (disk-preferred on conflict: the shards are newer by
    construction — they only exist if a sharded writer already ran) and
    the file is renamed to ``<path>.migrated`` so this never re-runs.
    Best-effort and idempotent: a crash mid-migration re-merges the
    remaining monolith on the next load, which the merge makes safe.
    """
    if not os.path.exists(path):
        return
    legacy = load_json_cache(path)
    if legacy:
        buckets: dict = {}
        for key, val in legacy.items():
            buckets.setdefault(shard_of(key), {})[key] = val
        shards = shard_paths(path)
        for idx, entries in buckets.items():
            # disk (shard) wins conflicts: resolve(old, new) -> old
            store_json_cache(shards[idx], entries, resolve=lambda old, new: old)
    try:
        os.replace(path, path + ".migrated")
    except OSError:
        pass


def load_sharded_json_cache(path: str) -> dict:
    """Union of all shards of the cache logically at ``path``, migrating
    a monolithic file found at ``path`` itself first."""
    _migrate_monolith(path)
    merged: dict = {}
    for shard in shard_paths(path):
        merged.update(load_json_cache(shard))
    return merged


def store_sharded_json_cache(path: str, cache: dict,
                             resolve: Optional[Callable] = None,
                             drop: Iterable = ()) -> None:
    """``store_json_cache`` semantics over the 16-shard layout.

    Entries and ``drop`` keys are routed to their shards; only shards
    with work are touched, so concurrent writers whose keys hash apart
    never contend on the same flock. A legacy monolith at ``path`` is
    migrated first so its entries participate in the merge.
    """
    _migrate_monolith(path)
    shards = shard_paths(path)
    buckets: dict = {}
    for key, val in cache.items():
        buckets.setdefault(shard_of(key), {})[key] = val
    drops: dict = {}
    for key in drop:
        drops.setdefault(shard_of(key), []).append(key)
    for idx in sorted(set(buckets) | set(drops)):
        store_json_cache(shards[idx], buckets.get(idx, {}),
                        resolve=resolve, drop=tuple(drops.get(idx, ())))
