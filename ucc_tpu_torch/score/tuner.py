"""Measurement-driven algorithm selection (the port of
``ucc_tpu/score/tuner.py``).

The static score map (score.py / score_map.py) encodes hand-set crossover
points between algorithms that ignore team size, hierarchy shape and the
machine running (on an H100, tl/torch_ops' default ``xla`` against
tl/ring_cuda's kernels, for one). This module replaces them with
measurement, behind ``UCC_TUNER``:

``off`` (default)
    Nothing happens; the dispatch path carries no new per-post branches
    (the probe lane of core/coll.py is an instance-attribute binding).

``offline``
    At team activation the topology-keyed tuning cache
    (``UCC_TUNER_CACHE``, default ``~/.cache/ucc_tpu_torch/tune.json``,
    never the JAX package's file) is loaded; entries matching the team's :func:`topo_signature` are
    compiled into the ScoreMap in place (``apply_learned``, provenance
    ``learned``). The cache is produced by the ``ucc_tune`` CLI
    (tools/tune.py offline sweep), by ``ucc_perftest --sweep``
    measurement files, or by earlier ``online`` runs.

``online``
    Offline behavior PLUS live exploration: for the first
    ``UCC_TUNER_SAMPLES`` posts of each (coll, mem, size-bucket) key the
    dispatcher rotates through the live candidates, timing post ->
    completion (on CUDA memory, completion is the launch's event: the
    stream work has finished). Because ranks must never diverge on
    algorithm choice,
    rotation is deterministic (per-key post counter x the
    deterministically-sorted candidate list — identical on every rank),
    and the final decision is rank-0-authoritative: when the budget is
    spent every rank posts a service-team bcast, rank 0 publishes its
    measured winner, and each rank freezes that
    winner into its ScoreMap before leaving the probe lane. Rank 0 also
    persists the decision to the cache, so the next run starts tuned
    with zero exploration posts.

Only collectives whose ``msgsize`` is identical on every rank are tuned
(:data:`TUNABLE_COLLS`): the per-key post counter is the cross-rank
synchronization primitive, and a rank-dependent size bucket would
desynchronize it. In one process the last rank's post launches a device
round for every rank, so rank 0's samples include the wait for its
peers' posts; the winner is rank 0's.

``topo_signature`` names the loaded TLs, so the port's signatures name
``torch_ops``/``ring_cuda`` where the JAX package's name ``xla``/
``ring_dma``; the format and ``CACHE_VERSION`` are the JAX package's.
"""
from __future__ import annotations

import json
import os
import pickle
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..constants import CollType, MemoryType, coll_type_str
from ..obs import metrics
from ..status import Status, UccError
from ..utils.config import SIZE_INF
from ..utils.log import get_logger
from .score import MsgRange
from .score_map import comp_name

logger = get_logger("tuner")

DEFAULT_CACHE = "~/.cache/ucc_tpu_torch/tune.json"
CACHE_VERSION = 1

#: collectives safe to tune online: their selection msgsize
#: (api/types.coll_args_msgsize) is a pure function of (count, dtype)
#: identical on every rank, so the per-key exploration counters stay in
#: lockstep. v-colls and gather/scatter are excluded — their msgsize can
#: differ per rank (root buffers, per-rank counts), which would put
#: ranks in different buckets and deadlock the rotation.
TUNABLE_COLLS = frozenset((
    CollType.ALLREDUCE, CollType.ALLGATHER, CollType.ALLTOALL,
    CollType.BCAST, CollType.REDUCE, CollType.REDUCE_SCATTER,
    CollType.BARRIER))

_COLL_BY_NAME = {coll_type_str(c): c for c in CollType}
_MEM_BY_NAME = {"host": MemoryType.HOST, "cuda": MemoryType.CUDA,
                "cuda_managed": MemoryType.CUDA_MANAGED}

Key = Tuple[CollType, MemoryType, int]       # (coll, mem, size bucket)
Label = Tuple[str, str]                      # (component, alg name)


def cand_label(cand: MsgRange) -> Label:
    """Stable cross-rank identity of a candidate: (serving component,
    algorithm name) — e.g. ("shm", "sra_knomial")."""
    return (comp_name(cand), cand.alg_name or "")


def size_bucket(msgsize: int) -> int:
    """Log2 size bucket; bucket b covers [2^(b-1), 2^b), bucket 0 is
    msgsize 0 (same convention as the metrics histograms)."""
    return int(msgsize).bit_length()


def bucket_range(bucket: int) -> Tuple[int, int]:
    if bucket <= 0:
        return (0, 1)
    return (1 << (bucket - 1), 1 << bucket)


# ---------------------------------------------------------------------------
# topology signature
# ---------------------------------------------------------------------------

def topo_signature(team) -> str:
    """Key a tuning decision to everything that invalidates it: team
    size, node layout (per-node member counts from topo/), the TL set the
    context loaded, and the lib thread mode. Pids, team ids and hostnames
    are left out, so decisions carry over between runs on same-shaped
    machines."""
    ctx = getattr(team, "context", None)
    tls = ",".join(sorted(getattr(ctx, "tl_contexts", {}) or {}))
    tm = getattr(getattr(getattr(ctx, "lib", None), "params", None),
                 "thread_mode", None)
    tm_s = getattr(tm, "name", str(tm)).lower()
    topo = getattr(team, "topo", None)
    if topo is not None:
        layout = topo.node_layout()
        nodes = len(layout)
        layout_s = ",".join(str(c) for c in layout)
    else:
        nodes, layout_s = 1, str(getattr(team, "size", 1))
    return (f"v{CACHE_VERSION}|n{team.size}|nodes{nodes}|ppn{layout_s}"
            f"|tls={tls}|tm={tm_s}")


# ---------------------------------------------------------------------------
# tuning cache (JSON, keyed by topology signature)
# ---------------------------------------------------------------------------

def resolve_cache_path(raw: str = "") -> str:
    return os.path.expanduser(raw or DEFAULT_CACHE)


def load_cache(path: str) -> Dict[str, Any]:
    try:
        with open(path) as fh:
            data = json.load(fh)
        if isinstance(data, dict):
            return data
    except (OSError, ValueError):
        pass
    return {}


def cache_entries(cache: Dict[str, Any], signature: str) -> List[dict]:
    sig = (cache.get("signatures") or {}).get(signature) or {}
    entries = sig.get("entries")
    return list(entries) if isinstance(entries, list) else []


def store_entries(path: str, signature: str, entries: Sequence[dict],
                  source: str = "offline") -> None:
    """Merge *entries* into the cache file under *signature* and write it
    atomically (tmp + rename). Entries replace existing ones with the
    same (coll, mem, start, end) window."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # exclusive advisory lock around the read-modify-write: two rank-0
    # processes (two jobs on one machine, two teams freezing keys) must
    # not each replace the file from their own pre-merge snapshot — the
    # atomic rename alone would silently drop the other writer's entries
    with open(f"{path}.lock", "w") as lk:
        try:
            import fcntl
            fcntl.flock(lk, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass                    # no flock: best-effort (non-POSIX)
        cache = load_cache(path)
        cache.setdefault("version", CACHE_VERSION)
        sigs = cache.setdefault("signatures", {})
        slot = sigs.setdefault(signature, {})
        old = {(e.get("coll"), e.get("mem"), e.get("start"),
                e.get("end")): e
               for e in (slot.get("entries") or []) if isinstance(e, dict)}
        for e in entries:
            old[(e.get("coll"), e.get("mem"), e.get("start"),
                 e.get("end"))] = dict(e)
        slot["entries"] = sorted(
            old.values(),
            key=lambda e: (str(e.get("coll")), str(e.get("mem")),
                           int(e.get("start") or 0)))
        slot["updated"] = time.time()
        slot["source"] = source
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(cache, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)


# in-process session cache: decisions frozen by ANY team this process has
# run, keyed like the file cache. A later team of the same shape starts
# from it even when the file cache is disabled or the decision has not
# reached the disk yet
_SESSION_CACHE: Dict[str, Dict[Tuple, dict]] = {}


def _entry_key(e: dict) -> Tuple:
    return (e.get("coll"), e.get("mem"), e.get("start"), e.get("end"))


def session_record(signature: str, entries: Sequence[dict]) -> None:
    slot = _SESSION_CACHE.setdefault(signature, {})
    for e in entries:
        if isinstance(e, dict):
            slot[_entry_key(e)] = dict(e)


def session_merged_entries(signature: str,
                           file_entries: Sequence[dict]) -> List[dict]:
    """File-cache entries overlaid with this process's session decisions
    (session wins: it is at least as new as anything on disk)."""
    merged = {_entry_key(e): e for e in file_entries
              if isinstance(e, dict)}
    merged.update(_SESSION_CACHE.get(signature) or {})
    return list(merged.values())


def session_reset() -> None:
    _SESSION_CACHE.clear()


def apply_entries(score_map, entries: Sequence[dict]) -> List[Tuple]:
    """Compile cache *entries* into *score_map* (apply_learned per
    entry, carrying the entry's origin — "learned" or "searched").
    Returns the (coll, mem, start, end) windows that actually applied —
    the keys online exploration must skip.

    Staleness guard: an entry whose ``gen`` field names a generated
    algorithm that no longer registers on this build (family grid
    changed, UCC_GEN_DEVICE off) is dropped with a warning and the
    ``tuner_stale_entries_dropped`` metric instead of compiling a dead
    candidate into the score map; its window stays open for the static
    defaults and later tuning."""
    covered: List[Tuple] = []
    for e in entries:
        coll = _COLL_BY_NAME.get(str(e.get("coll", "")))
        mem = _MEM_BY_NAME.get(str(e.get("mem", "")))
        alg = str(e.get("alg", "") or "")
        if coll is None or mem is None or not alg:
            continue
        try:
            start, end = int(e.get("start", 0)), int(e.get("end", 0))
        except (TypeError, ValueError):
            continue
        origin = str(e.get("origin") or "learned")
        if score_map.apply_learned(coll, mem, start, end, alg,
                                   comp=e.get("comp"), origin=origin):
            covered.append((coll, mem, start, end))
        elif e.get("gen") or alg.startswith("gen_"):
            logger.warning(
                "tuner: dropping stale cache entry %s/%s [%d..%d) -> "
                "%s (%s): the generated algorithm no longer registers "
                "on this build (UCC_GEN_DEVICE off? family grid "
                "changed?)",
                str(e.get("coll")), str(e.get("mem")), start, end, alg,
                e.get("gen") or "no gen params")
            if metrics.ENABLED:
                metrics.inc("tuner_stale_entries_dropped",
                            component="tuner", coll=str(e.get("coll")),
                            alg=alg)
        else:
            logger.debug("tuner: cache entry %s has no matching candidate "
                         "on this build; ignoring", e)
    return covered


def compile_measurements(records: Sequence[dict]) -> List[dict]:
    """Compile sweep measurement records (one per (coll, mem, size, alg)
    — the `ucc_perftest --sweep` / `ucc_tune` format) into learned cache
    entries: winner per grid point by lowest p50 (avg fallback), then
    adjacent grid points with the same winner merge into one
    [start, end) range with boundaries at the grid points; the first
    range extends to 0 and the last to inf."""
    by_point: Dict[Tuple[str, str, int], Tuple[Tuple[str, Any], float]] = {}
    for r in records:
        try:
            coll = str(r["coll"])
            mem = str(r.get("mem", "host"))
            size = int(r["size_bytes"])
            alg = str(r["alg"])
            lat = float(r.get("p50_us") if r.get("p50_us") is not None
                        else r["avg_us"])
        except (KeyError, TypeError, ValueError):
            continue
        key = (coll, mem, size)
        cur = by_point.get(key)
        if cur is None or lat < cur[1]:
            by_point[key] = ((alg, r.get("comp"),
                              str(r.get("precision") or ""),
                              str(r.get("gen") or "")), lat)
    series: Dict[Tuple[str, str], List[Tuple[int, Tuple[str, Any]]]] = {}
    for (coll, mem, size), (winner, _lat) in by_point.items():
        series.setdefault((coll, mem), []).append((size, winner))
    entries: List[dict] = []
    for (coll, mem), pts in sorted(series.items()):
        pts.sort()
        bounds = [0] + [s for s, _ in pts[1:]] + [SIZE_INF]
        i = 0
        while i < len(pts):
            j = i
            while j + 1 < len(pts) and pts[j + 1][1] == pts[i][1]:
                j += 1
            alg, comp, prec, gen = pts[i][1]
            e = {"coll": coll, "mem": mem, "start": bounds[i],
                 "end": bounds[j + 1], "alg": alg}
            if comp:
                e["comp"] = comp
            if prec:
                e["precision"] = prec
            if gen:
                e["gen"] = gen
            entries.append(e)
            i = j + 1
    return entries


# ---------------------------------------------------------------------------
# online tuner
# ---------------------------------------------------------------------------

@dataclass
class _KeyState:
    count: int = 0                       # tuned posts so far (lockstep)
    samples: Dict[Label, List[float]] = field(default_factory=dict)
    unsupported: Set[Label] = field(default_factory=set)
    decision: Any = None                 # in-flight service bcast task
    #: deterministic post index at which EVERY rank applies the decision
    #: (set when the decision is posted; same on all ranks)
    switch_at: Optional[int] = None
    #: weakref to the one bound CollRequest allowed to drive this key
    #: (overlapped same-key posts deterministically end tuning — claim())
    active: Any = None
    frozen: bool = False
    winner: Optional[Label] = None       # None = keep static defaults


class OnlineTuner:
    """Per-team online exploration state. Attached as ``team.tuner`` by
    :func:`activation_end` (None when UCC_TUNER != online — core
    dispatch checks the attribute once per collective INIT, never per
    post).

    Divergence safety: ranks observe the decision bcast's COMPLETION at
    different wall-clock times, so freezing "when my bcast completes"
    would let one rank run the winner while a peer still explores — a
    deadlock. Instead the switch point is a deterministic POST INDEX:
    after the exploration budget every rank runs a hold phase on the
    deterministic static-best candidate for ``_slack`` posts, then all
    switch at the same count. Reaching the switch post requires
    completing ``_slack`` full collectives (every rank participates in
    each, so every rank runs progress passes that also advance the
    radix-4 service bcast by at least one tree level per collective) —
    by the switch post the decision is causally delivered everywhere.
    """

    def __init__(self, team, samples: int, cache_path: str,
                 signature: str, covered: Sequence[Tuple]):
        self.team = team
        self.samples_target = max(2, int(samples))
        self.cache_path = cache_path
        self.signature = signature
        self.covered = list(covered)
        self._keys: Dict[Key, _KeyState] = {}
        # hold-window length: service-bcast tree depth (radix 4) plus
        # margin — one full collective per tree level is already far
        # more progress than one bcast hop needs
        depth = 0
        n = max(1, int(getattr(team, "size", 1)))
        while (4 ** depth) < n:
            depth += 1
        self._slack = depth + 2

    # -- dispatch-side queries -----------------------------------------
    @staticmethod
    def key_for(coll: CollType, mem: MemoryType, msgsize: int) -> Key:
        return (coll, mem, size_bucket(msgsize))

    def wants(self, coll: CollType, mem: MemoryType, msgsize: int,
              candidates: Sequence[MsgRange]) -> bool:
        """Should this (coll, mem, msgsize) enter the probe lane?"""
        if coll not in TUNABLE_COLLS:
            return False
        st = self._keys.get((coll, mem, size_bucket(msgsize)))
        if st is not None and st.frozen:
            return False
        for (c, m, s, e) in self.covered:
            if c == coll and m == mem and s <= msgsize < e:
                return False      # cache already answered this window
        live = sum(1 for c in candidates if c.init is not None)
        return live > 1

    def exploring(self, key: Key) -> bool:
        st = self._keys.get(key)
        return st is None or not st.frozen

    def claim(self, key: Key, req) -> bool:
        """Serialize the probe lane per key: only one un-finalized
        request may drive a key's lockstep counters. A second same-key
        request posting while the first is not yet finalized means the
        app overlaps posts (streaming) — overlapped post->completion
        timings are meaningless, and worse, the hold window's causality
        argument (reaching the switch post requires COMPLETING slack
        collectives) no longer holds, so the key is deterministically
        frozen to the static defaults instead. Finalize order is program
        order — identical on every rank — unlike completion state, which
        is timing-dependent and would diverge."""
        st = self._keys.setdefault(key, _KeyState())
        if st.frozen:
            return False
        holder = st.active() if st.active is not None else None
        if holder is None or holder is req or \
                getattr(holder, "_finalized", False):
            st.active = weakref.ref(req)
            return True
        logger.info("tuner: overlapped posts on %s/%s; tuning this key "
                    "frozen to static defaults",
                    coll_type_str(key[0]), key[1].name.lower())
        if metrics.ENABLED:
            metrics.inc("tuner_concurrent_posts", component="tuner",
                        coll=coll_type_str(key[0]))
        # an in-flight decision bcast (every rank posted its half at the
        # same index) is left to complete in the progress queue
        st.frozen = True
        st.winner = None
        return False

    # -- exploration ----------------------------------------------------
    def explore_order(self, key: Key,
                      candidates: Sequence[MsgRange]) -> List[MsgRange]:
        """Candidate walk order for the next tuned post of *key*.
        Deterministic on every rank: same per-key counter, same
        deterministically-sorted candidate list, same (symmetric)
        unsupported set. Consumes one exploration slot; posts the
        rank-0 decision bcast once the budget is spent; after that,
        hold-phase posts walk the static-best order (no rotation) until
        the deterministic switch index."""
        st = self._keys.setdefault(key, _KeyState())
        k = st.count
        st.count += 1
        if metrics.ENABLED:
            metrics.inc("tuner_explore_posts", component="tuner",
                        coll=coll_type_str(key[0]))
        live = [c for c in candidates
                if c.init is not None and cand_label(c) not in
                st.unsupported]
        if not live:
            # nothing explorable at all: freeze to the static defaults
            # so dispatch stops re-binding the probe lane for this key
            st.frozen = True
            st.winner = None
            return []
        if k >= self.samples_target:
            # hold phase: every rank runs the deterministic static-best
            # walk until the switch index. The decision is posted HERE,
            # on the first hold post, not on the last exploration post —
            # by now the final exploration round has completed (posts
            # are serialized per key, claim()), so rank 0's winner is
            # computed over every candidate's samples; posting it one
            # post earlier would permanently blind the decision to the
            # last-rotation candidate(s)
            if st.decision is None and not st.frozen:
                self._post_decision(key, st)
            return list(live)
        rot = k % len(live)
        return list(live[rot:]) + list(live[:rot])

    def record(self, key: Key, label: Label, secs: float, status) -> None:
        st = self._keys.get(key)
        if st is None or st.frozen:
            return
        if status is not None and getattr(status, "is_error", False):
            secs = float("inf")   # an erroring candidate never wins
        st.samples.setdefault(label, []).append(secs)

    def record_unsupported(self, key: Key, cand: MsgRange) -> None:
        st = self._keys.setdefault(key, _KeyState())
        st.unsupported.add(cand_label(cand))

    # -- decision -------------------------------------------------------
    def _local_winner(self, st: _KeyState
                      ) -> Tuple[Optional[Label], Optional[float]]:
        """The lowest median sample, each median weighted by the
        straggler feedback (obs/collector.RankBias.time_multiplier): a
        ring-family winner measured before a straggler showed must beat
        the others by the slowness factor to be frozen. Only rank 0's
        winner is broadcast, so reading local state here cannot make
        ranks diverge."""
        bias = getattr(self.team, "rank_bias", None)
        best, best_t = None, None
        for label in sorted(st.samples):       # sorted: deterministic ties
            ts = sorted(st.samples[label])
            if not ts:
                continue
            med = ts[len(ts) // 2]
            if bias is not None and med != float("inf"):
                med *= bias.time_multiplier(label[1])
            if med != float("inf") and (best_t is None or med < best_t):
                best, best_t = label, med
        return best, best_t

    def _post_decision(self, key: Key, st: _KeyState) -> None:
        team = self.team
        svc = getattr(team, "service_team", None)
        if svc is None or not hasattr(svc, "service_bcast"):
            # no decision channel (attach-time guard means size 1 only):
            # this rank's winner IS the team's winner
            winner, _ = self._local_winner(st)
            st.frozen = True
            st.winner = winner
            self._freeze(key, st, winner)
            return
        payload = None
        if team.rank == 0:
            winner, med = self._local_winner(st)
            payload = pickle.dumps({
                "key": (int(key[0]), int(key[1]), int(key[2])),
                "winner": winner, "med_s": med})
        task = svc.service_bcast(payload, 0)
        task.post()
        st.decision = task
        # every rank posts the decision at the same tuned-post count, so
        # this switch index is identical everywhere — the divergence-free
        # point at which all ranks apply the winner
        st.switch_at = st.count + self._slack

    def poll(self, key: Key) -> Tuple[bool, Optional[Label]]:
        """(frozen?, winner label or None-for-keep-defaults). The
        decision is applied to the score map only at the deterministic
        switch index — never "as soon as my bcast completed", which
        differs per rank (see class docstring)."""
        st = self._keys.get(key)
        if st is None:
            return (False, None)
        if st.frozen:
            return (True, st.winner)
        task = st.decision
        if task is None or st.switch_at is None or \
                st.count < st.switch_at:
            return (False, None)
        if not task.is_completed():
            # causally impossible for a progressing team (each hold-phase
            # collective outlasts one service-bcast hop) unless the
            # service team faulted mid-decision; keep the deterministic
            # static default rather than guessing, and unwind the task's
            # posted recvs so they don't linger in the mailbox
            logger.error("tuner: decision for %s not delivered by the "
                         "switch post (service team faulted?); keeping "
                         "static defaults", coll_type_str(key[0]))
            if metrics.ENABLED:
                metrics.inc("tuner_decision_late", component="tuner",
                            coll=coll_type_str(key[0]))
            task.cancel(Status.ERR_TIMED_OUT)
            try:
                task.finalize()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
            st.decision = None
            st.frozen = True
            st.winner = None
            return (True, None)
        st.decision = None
        winner: Optional[Label] = None
        if task.super_status.is_error:
            logger.warning("tuner: decision bcast for %s failed (%s); "
                           "keeping static defaults",
                           coll_type_str(key[0]), task.super_status.name)
        else:
            try:
                data = task.result
                msg = pickle.loads(data) if data else {}
                got_key = tuple(msg.get("key") or ())
                if got_key and got_key != (int(key[0]), int(key[1]),
                                           int(key[2])):
                    logger.error("tuner: decision/key mismatch (%s != %s); "
                                 "keeping static defaults", got_key, key)
                elif msg.get("winner") is not None:
                    winner = tuple(msg["winner"])  # type: ignore[assignment]
            except Exception:  # noqa: BLE001 - a bad payload must not wedge
                logger.exception("tuner: undecodable decision payload")
        try:
            task.finalize()
        except Exception:  # noqa: BLE001 - service task teardown best-effort
            pass
        st.frozen = True
        st.winner = winner
        self._freeze(key, st, winner)
        return (True, winner)

    def _freeze(self, key: Key, st: _KeyState,
                winner: Optional[Label]) -> None:
        coll, mem, bucket = key
        if winner is None:
            logger.info("tuner: %s/%s bucket %d frozen to static defaults",
                        coll_type_str(coll), mem.name.lower(), bucket)
            return
        comp, alg = winner
        start, end = bucket_range(bucket)
        ok = self.team.score_map.apply_learned(coll, mem, start, end, alg,
                                               comp=comp)
        if metrics.ENABLED:
            metrics.inc("tuner_decisions", component="tuner",
                        coll=coll_type_str(coll), alg=alg)
        logger.info("tuner: %s/%s [%d..%d) frozen to %s/%s (team %s)",
                    coll_type_str(coll), mem.name.lower(), start, end,
                    comp, alg, self.team.id)
        if ok and self.team.rank == 0:
            entry = {"coll": coll_type_str(coll), "mem": mem.name.lower(),
                     "start": start, "end": end, "alg": alg, "comp": comp}
            # record the winner's wire-precision tag (quantized
            # variants) and generated family/parameters (DSL variants)
            # so cache files name what a learned range actually runs
            for r in self.team.score_map.lookup(coll, mem, start):
                if cand_label(r) == winner:
                    if r.precision:
                        entry["precision"] = r.precision
                    if r.gen:
                        entry["gen"] = r.gen
                    break
            # session cache first: a later team of this shape starts from
            # it even if the disk write below fails or is disabled
            session_record(self.signature, [entry])
            if self.cache_path:
                try:
                    store_entries(self.cache_path, self.signature,
                                  [entry], source="online")
                except OSError as e:
                    logger.warning("tuner: cache write to %s failed: %s",
                                   self.cache_path, e)


# ---------------------------------------------------------------------------
# team activation hooks (driven by the team-create state machine)
# ---------------------------------------------------------------------------

def _tuner_mode(team) -> str:
    try:
        mode = (team.context.lib.config.tuner or "off").strip().lower()
    except AttributeError:
        return "off"
    return mode if mode in ("offline", "online") else "off"


def _team_cache_path(team) -> str:
    cfg = team.context.lib.config
    return resolve_cache_path(str(getattr(cfg, "tuner_cache", "") or ""))


def activation_begin(team):
    """Post the cache-sync round from the team-create state machine
    (TeamState.TUNER_SYNC). The tuning cache is a per-NODE local file:
    applying it per-rank would let nodes with different cache contents
    (no shared home dir, stale copies) compile different score maps and
    deadlock the first collective. So rank 0's view is authoritative —
    it loads its cache and bcasts the matching entries over the service
    team; every rank applies exactly that payload. Returns the posted
    bcast task, or None when no round is needed (UCC_TUNER=off, 1-rank
    team, or no bcast-capable service team — then tuning is disabled in
    :func:`activation_end`)."""
    if _tuner_mode(team) == "off" or team.size <= 1:
        return None
    svc = team.service_team
    if svc is None or not hasattr(svc, "service_bcast"):
        return None
    payload = None
    if team.rank == 0:
        sig = topo_signature(team)
        entries = session_merged_entries(
            sig, cache_entries(load_cache(_team_cache_path(team)), sig))
        payload = pickle.dumps({"entries": entries})
    task = svc.service_bcast(payload, 0)
    task.post()
    return task


def activation_end(team, sync_task) -> None:
    """Apply the synced (or, for 1-rank teams, local) cache entries to
    the freshly-built score map and attach the online explorer. One
    config read and an immediate return when UCC_TUNER=off."""
    mode = _tuner_mode(team)
    if mode == "off":
        return
    path = _team_cache_path(team)
    sig = topo_signature(team)
    entries: List[dict] = []
    if sync_task is not None:
        st = sync_task.super_status
        data = b""
        if st.is_error:
            logger.warning("tuner: cache-sync bcast failed (%s) on team "
                           "%s; starting untuned", st.name, team.id)
        else:
            data = sync_task.result
        try:
            sync_task.finalize()
        except Exception:  # noqa: BLE001 - service task teardown
            pass
        if st.is_error:
            return              # no consistent view: stay untuned
        if data:
            try:
                entries = (pickle.loads(data) or {}).get("entries") or []
            except Exception:  # noqa: BLE001 - bad payload must not brick
                logger.exception("tuner: undecodable cache-sync payload")
                return
    elif team.size <= 1:
        entries = session_merged_entries(
            sig, cache_entries(load_cache(path), sig))
    else:
        # multi-rank team without a bcast-capable service team: per-rank
        # cache reads could diverge across nodes — tuning stays off
        logger.warning("tuner: no bcast-capable service team on team %s; "
                       "tuning disabled", team.id)
        return
    covered: List[Tuple] = []
    if entries:
        covered = apply_entries(team.score_map, entries)
        if metrics.ENABLED:
            metrics.inc("tuner_cache_entries_applied", len(covered),
                        component="tuner")
        logger.info("tuner: applied %d/%d learned entries for %s",
                    len(covered), len(entries), sig)
    if mode != "online":
        return
    try:
        samples = int(getattr(team.context.lib.config, "tuner_samples", 8)
                      or 8)
    except (TypeError, ValueError):
        samples = 8
    team.tuner = OnlineTuner(team, samples, path, sig, covered)


# ---------------------------------------------------------------------------
# offline sweep support (ucc_tune / ucc_perftest --sweep)
# ---------------------------------------------------------------------------

def sweep_candidates(team, coll: CollType, mem: MemoryType,
                     msgsize: int) -> List[MsgRange]:
    """The candidate set an offline sweep iterates for one grid point —
    the score map's deterministic lookup, so index i means the same
    algorithm on every rank."""
    return team.score_map.lookup(coll, mem, msgsize)


def forced_request(team, args, coll: CollType, mem: MemoryType,
                   msgsize: int, index: int):
    """Init a collective pinned to candidate *index* of the score map's
    lookup (no fallback walk — a NOT_SUPPORTED candidate raises so the
    sweep records it as skipped). Returns a CollRequest."""
    from ..core.coll import CollRequest, InitArgs
    cands = sweep_candidates(team, coll, mem, msgsize)
    cand = cands[index]
    ia = InitArgs(args=args, team=team, mem_type=mem, msgsize=msgsize)
    task, chosen = team.score_map.init_coll(coll, mem, msgsize, ia, [cand])
    task.coll_name = coll_type_str(coll)
    task.alg_name = str(chosen.alg_name or chosen.team)
    return CollRequest(task, team, args)


def measurement_record(coll_name: str, mem: MemoryType, ranks: int,
                       label: Label, size_bytes: int, count: int,
                       iters: int, stats: Dict[str, float],
                       precision: str = "", gen: str = "",
                       predicted_us: Optional[float] = None) -> dict:
    """The one sweep measurement-record shape (`ucc_tune` and
    `ucc_perftest --sweep` both emit it; `compile_measurements` and
    `ucc_tune --from` consume it). Centralized so the producers cannot
    drift — in particular ``mem`` is the CANONICAL memory-type name
    (mem.name.lower()), never a user-input alias like "cuda" that
    ``apply_entries`` would silently fail to resolve. ``precision``
    tags quantized candidates' rows and ``gen`` generated candidates'
    family/parameter string (both carried into compiled cache
    entries)."""
    comp, alg = label
    rec = {"bench": "sweep", "coll": coll_name, "mem": mem.name.lower(),
           "ranks": ranks, "comp": comp, "alg": alg,
           "size_bytes": size_bytes, "count": count, "iters": iters,
           **{k: round(v, 3) for k, v in stats.items()}}
    if precision:
        rec["precision"] = precision
    if gen:
        rec["gen"] = gen
    if predicted_us is not None:
        # the fitted cost model's price for this (program, size): sweep
        # output doubles as model-calibration data
        rec["predicted_us"] = round(float(predicted_us), 2)
    return rec


def measure_candidate(teams, contexts, argses, coll: CollType,
                      mem: MemoryType, msgsize: int, index: int,
                      iters: int, warmup: int,
                      timeout: float = 120.0) -> Optional[List[float]]:
    """The sweep engine shared by ``ucc_tune`` and
    ``ucc_perftest --sweep``: force candidate *index* on every rank
    (persistent args in *argses*), time ``warmup + iters`` rounds with
    a bounded wait (a pinned candidate has no fallback walk, so a
    wedged one must become a skipped row, not a dead sweep), and return
    the timed-round latencies in seconds — or None when the candidate
    refuses these args, errors, or times out."""
    reqs: List[Any] = []

    def finalize_all():
        for rq in reqs:
            try:
                rq.finalize()
            except Exception:  # noqa: BLE001 - sweep cleanup
                pass

    # EVERY rank attempts its init even when one refuses: a host task
    # takes a team coll tag before its NOT_SUPPORTED checks (a generated
    # pooled program refuses a team without an arena only then), so
    # stopping at the first refusal would leave the ranks' tag counters
    # apart and wedge every later candidate of the sweep
    refused = False
    for r, team in enumerate(teams):
        try:
            reqs.append(forced_request(team, argses[r], coll, mem,
                                       msgsize, index))
        except UccError:
            refused = True
    if refused:
        finalize_all()
        return None
    lats: List[float] = []
    ok = True
    for it in range(warmup + iters):
        t0 = time.perf_counter()
        for rq in reqs:
            rq.post()
        deadline = time.monotonic() + timeout
        while any(rq.test() == Status.IN_PROGRESS for rq in reqs):
            for c in contexts:
                c.progress()
            if time.monotonic() > deadline:
                for rq in reqs:
                    rq.task.cancel(Status.ERR_TIMED_OUT)
                ok = False
                break
        if not ok or any(rq.test() != Status.OK for rq in reqs):
            ok = False
            break
        if it >= warmup:
            lats.append(time.perf_counter() - t0)
    finalize_all()
    return lats if ok and lats else None
