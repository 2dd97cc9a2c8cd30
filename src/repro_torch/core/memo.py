"""Central memoization registry for the search/evaluation hot path.

The co-search re-derives a lot of identical intermediate state: the same
(format, tensor) pair is compiled once per op per pattern pair, the same
mapping space is enumerated once per pattern pair, and identical layers are
re-searched across pairs and models.  Modules register their caches here so
they can be cleared (tests, benchmarks) or bypassed (cache-correctness
checks, seed-path timing) in one place.

Cache keys are **value-based** (frozen-dataclass fields, dict items tuples)
rather than object identities, so equal inputs hit regardless of where they
were constructed.  Keys used across the codebase:

  * ``compile_format`` / ``analyze``: (format levels+name, dims items,
    sparsity model, value_bits);
  * ``enumerate_mappings``:   ((M, N, K), value_bits, arch, ratio_i,
    ratio_w, spatial_top, orders);
  * ``factorizations``:       (extent, parts);
  * ``reference_allocation``: (bare pattern levels, spec key) — seeded by
    ``generate_candidates`` as a by-product of its batched scan;
  * ``_search_op``:           (op shape+sparsity+count, arch, candidate
    pair, CoSearchConfig);
  * ``generate_candidates``:  (spec key, EngineConfig, penalize);
  * ``mapping_ctx``:          tagged entries over (op shape, arch, exact
    (ratio_i, ratio_w) tuple, spatial_top): ``("table", base)`` holds the
    cf_o-independent packed mapping table, ``("ctx", base, cf_o value
    key)`` the mapping-only half of the evaluator formulas — shared
    across pattern pairs whose reference ratios coincide;
  * ``fetch_table``:          ("ft", side, mapping_ctx base, population
    cf_keys) — per-(mapping table, format population) fetch matrices,
    shared across pattern pairs whose side populations coincide.

Unhashable inputs (e.g. a custom ``Sparsity`` subclass) silently skip the
cache — correctness never depends on a hit.

Every registered cache carries hit/miss counters (:func:`stats`,
:func:`stats_report`); lookups made while caching is disabled, or with a
``None`` key, are not counted.  Counters survive :func:`clear` (so a
cold-cache benchmark still reports its warm-up misses) and are zeroed with
:func:`reset_stats`.

:func:`export_state` / :func:`import_state` snapshot the registry as a
plain ``{cache name: entries}`` dict for shipping to worker processes
(:func:`repro_torch.core.cosearch.cosearch_multi` with ``executor="process"``):
keys and values are value-based, so a warmed child resolves the same
lookups the parent already paid for.  The reverse direction is
:func:`key_snapshot` + :func:`export_delta`: a worker records which keys
it started with and ships back only the entries IT computed, so the
parent's caches absorb every worker's work (later searches over shared op
shapes replay instead of recomputing).

:func:`save` / :func:`load` make snapshots DURABLE: pickled to disk with a
format version + :func:`code_fingerprint` key, so a later process warms up
from a previous run's work — and silently ignores snapshots written by
different code.  The fingerprint hashes THIS package's sources, so a
snapshot the JAX package wrote never loads here, nor the other way round:
the two packages' cache values come from different files.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Iterator, Optional, Sequence

_REGISTRY: list[dict] = []
_enabled: bool = True
_MISS = object()                # distinguishes a cached None from a miss
_STATS_LOCK = threading.Lock()  # counters stay exact under cosearch_multi's
#                                 thread-sharded work-list


@dataclasses.dataclass
class CacheStats:
    """Hit/miss counters for one registered cache."""

    name: str
    hits: int = 0
    misses: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


_STATS: dict[int, CacheStats] = {}      # id(cache) -> counters


def register(cache: dict, name: Optional[str] = None) -> dict:
    """Register a module-level cache dict for global clear/disable."""
    _REGISTRY.append(cache)
    _STATS[id(cache)] = CacheStats(name or f"cache{len(_REGISTRY)}")
    return cache


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = on


def clear(names: Optional[Sequence[str]] = None) -> None:
    """Empty registered caches (all of them, or just the named ones).

    Selective clearing lets benchmarks cool exactly the plane under test
    (e.g. ``clear(names=["search_op", "mapping_ctx"])``) while the shared
    compile/enumeration caches stay warm for both compared paths.  Unknown
    names raise — a typo'd name silently left warm would turn a cold-cache
    measurement into a warm-vs-warm one."""
    if names is not None:
        unknown = set(names) - {st.name for st in _STATS.values()}
        if unknown:
            raise KeyError(f"unregistered cache name(s): {sorted(unknown)}")
    for c in _REGISTRY:
        if names is not None and _STATS[id(c)].name not in names:
            continue
        c.clear()


def note(cache: dict, hit: bool) -> None:
    """Record a hit/miss for a registered cache that is probed manually
    (without :func:`get_or`)."""
    st = _STATS.get(id(cache))
    if st is not None:
        with _STATS_LOCK:
            if hit:
                st.hits += 1
            else:
                st.misses += 1


def stats() -> dict[str, CacheStats]:
    """Per-cache counters, keyed by the name given at :func:`register`."""
    return {st.name: st for st in _STATS.values()}


def reset_stats() -> None:
    for st in _STATS.values():
        st.hits = 0
        st.misses = 0


def stats_report(only_active: bool = True) -> str:
    """One-line ``name=hits/lookups(rate)`` summary, for benchmark output."""
    parts = []
    for st in sorted(_STATS.values(), key=lambda s: s.name):
        if only_active and not st.lookups:
            continue
        parts.append(f"{st.name}={st.hits}/{st.lookups}"
                     f"({100.0 * st.hit_rate:.0f}%)")
    return " ".join(parts) if parts else "no-cache-activity"


def export_state(names: Optional[Sequence[str]] = None,
                 picklable_only: bool = True) -> dict[str, dict]:
    """Snapshot registered caches as ``{name: {key: value}}``.

    ``names`` restricts the snapshot to specific caches; by default every
    registered cache is included.  With ``picklable_only`` (the default —
    required when the snapshot crosses a process boundary), entries whose
    (key, value) cannot be pickled are silently dropped: correctness never
    depends on a cache hit, so a dropped entry just recomputes in the
    importer."""
    out: dict[str, dict] = {}
    for cache in _REGISTRY:
        name = _STATS[id(cache)].name
        if names is not None and name not in names:
            continue
        entries = dict(cache)
        if picklable_only:
            entries = _picklable_entries(entries)
        out[name] = entries
    return out


def _picklable_entries(entries: dict) -> dict:
    import pickle
    try:
        pickle.dumps(entries)             # common case: one pass, all good
        return entries
    except Exception:
        kept = {}
        for k, v in entries.items():
            try:
                pickle.dumps((k, v))
            except Exception:
                continue
            kept[k] = v
        return kept


def key_snapshot(names: Optional[Sequence[str]] = None) -> dict[str, set]:
    """Current key sets of the (named) registered caches — the baseline a
    later :func:`export_delta` diffs against."""
    out: dict[str, set] = {}
    for cache in _REGISTRY:
        name = _STATS[id(cache)].name
        if names is not None and name not in names:
            continue
        out[name] = set(cache.keys())
    return out


def export_delta(baseline: dict[str, set],
                 names: Optional[Sequence[str]] = None,
                 picklable_only: bool = True) -> dict[str, dict]:
    """:func:`export_state` restricted to entries whose keys are NOT in
    ``baseline`` (a :func:`key_snapshot`) — what THIS process computed since
    the snapshot.  Process workers ship these back so the parent's
    :func:`import_state` absorbs their work; caches named in ``baseline``
    but absent from ``names`` (or vice versa) are simply skipped."""
    out: dict[str, dict] = {}
    for cache in _REGISTRY:
        name = _STATS[id(cache)].name
        if names is not None and name not in names:
            continue
        if name not in baseline:
            continue
        seen = baseline[name]
        entries = {k: v for k, v in cache.items() if k not in seen}
        if picklable_only:
            entries = _picklable_entries(entries)
        if entries:
            out[name] = entries
    return out


def import_state(state: dict[str, dict]) -> None:
    """Merge an :func:`export_state` snapshot into the registered caches.

    Matching is by cache name; snapshot entries win over nothing (existing
    entries are kept — equal keys map to equal values, both sides being
    pure functions of the key).  Unknown names are ignored, so a snapshot
    from a process with extra registrations imports cleanly."""
    by_name = {_STATS[id(c)].name: c for c in _REGISTRY}
    for name, entries in state.items():
        cache = by_name.get(name)
        if cache is not None:
            for k, v in entries.items():
                cache.setdefault(k, v)


# ---------------------------------------------------------------------------
# Durable snapshots (the persistent memo store)
# ---------------------------------------------------------------------------

_SNAPSHOT_VERSION = 1
_FINGERPRINT: Optional[str] = None


def code_fingerprint() -> str:
    """SHA-256 over the ``repro_torch`` package's source files.

    Cache values are pure functions of their keys ONLY while the code that
    computes them is unchanged — a durable snapshot keyed on this hash can
    never replay entries produced by different formulas."""
    global _FINGERPRINT
    if _FINGERPRINT is None:
        import hashlib
        import os
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        h = hashlib.sha256()
        for root, dirs, files in sorted(os.walk(pkg)):
            dirs.sort()
            for f in sorted(files):
                if not f.endswith(".py"):
                    continue
                path = os.path.join(root, f)
                h.update(os.path.relpath(path, pkg).encode())
                with open(path, "rb") as fh:
                    h.update(fh.read())
        _FINGERPRINT = h.hexdigest()
    return _FINGERPRINT


def save(path: str, names: Optional[Sequence[str]] = None) -> int:
    """Write a durable snapshot of the (named) registered caches to
    ``path``; returns the number of entries written.

    The snapshot is pickled with a format version and the current
    :func:`code_fingerprint`, so :func:`load` can reject snapshots from a
    different code state instead of replaying stale values."""
    import pickle
    state = export_state(names)
    with open(path, "wb") as f:
        pickle.dump({"version": _SNAPSHOT_VERSION,
                     "fingerprint": code_fingerprint(),
                     "state": state}, f)
    return sum(len(v) for v in state.values())


def load(path: str) -> bool:
    """Merge a :func:`save` snapshot from ``path`` into the registry.

    Returns True when the snapshot was imported.  A missing, unreadable,
    or STALE snapshot (version or code-fingerprint mismatch) returns False
    without touching the caches — persistence is an optimization, never a
    correctness dependency, so staleness is ignored, not crashed on."""
    import pickle
    try:
        with open(path, "rb") as f:
            snap = pickle.load(f)
        if (snap.get("version") != _SNAPSHOT_VERSION
                or snap.get("fingerprint") != code_fingerprint()):
            return False
        state = snap["state"]
    except Exception:
        return False
    import_state(state)
    return True


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Temporarily bypass every registered cache (they keep their entries)."""
    global _enabled
    prev = _enabled
    _enabled = False
    try:
        yield
    finally:
        _enabled = prev


def get_or(cache: dict, key: Any, compute: Callable[[], Any]) -> Any:
    """``cache[key]`` or ``compute()`` (stored), honoring the global switch.

    ``key`` may be None (caller found its inputs unhashable) — then this is
    a plain ``compute()``.
    """
    if key is None or not _enabled:
        return compute()
    try:
        hit = cache.get(key, _MISS)
    except TypeError:           # unhashable component slipped into the key
        return compute()
    if hit is _MISS:
        note(cache, False)
        hit = compute()
        cache[key] = hit
    else:
        note(cache, True)
    return hit
