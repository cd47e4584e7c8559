"""Library object — the root of the framework (UCC's ``ucc_init``).

Parse the global ``UCC_*`` config, load the CL/TL component frameworks,
init each requested CL lib plus the TLs it needs, and compute the lib attr
(thread mode, union of supported collective types).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..api.types import LibAttr, LibParams
from ..constants import COLL_TYPE_ALL, CollType
from ..status import Status, UccError
from ..utils.config import (Config, ConfigField, ConfigTable, parse_bool,
                            parse_enum, parse_list, parse_string, parse_uint,
                            register_table)
from ..utils.log import get_logger
from .components import (available_cls, available_tls, discover_components,
                         get_cl, get_tl)

logger = get_logger("core")

#: global config table: the fields of the JAX package's table that the
#: port reads, with its defaults
GLOBAL_CONFIG = register_table(ConfigTable(prefix="", name="global", fields=[
    ConfigField("CLS", "basic,hier", "comma-separated CL list ('all' for every "
                "available CL)", parse_list),
    ConfigField("TLS", "all", "comma-separated TL allow-list", parse_list),
    ConfigField("LOG_LEVEL", "warn", "ucc log level", parse_string),
    ConfigField("COLL_TRACE", "n", "log every collective init/post with the "
                "selected CL/TL", parse_bool),
    # the knobs below are read from the environment at import by the
    # modules that use them (utils/profiling, obs/, fault/, core/team,
    # core/oob), so that the off path costs nothing; listed here so that
    # `ucc_info -cf` documents them
    ConfigField("PROFILE_MODE", "", "profiling mode: log,accum", parse_string),
    ConfigField("STATS", "n", "enable the metrics registry "
                "(counters/gauges/log2 histograms keyed by component/"
                "collective/algorithm); dumped at exit, on SIGUSR2, and "
                "every STATS_INTERVAL; read by the ucc_stats tool",
                parse_bool),
    ConfigField("STATS_FILE", "ucc_stats.json", "metrics dump file "
                "(JSON lines, one snapshot per dump)", parse_string),
    ConfigField("STATS_INTERVAL", "0", "seconds between periodic metric "
                "dumps (0 = exit/SIGUSR2 only)", parse_string),
    ConfigField("WATCHDOG_TIMEOUT", "0", "stall watchdog soft deadline in "
                "seconds: any task IN_PROGRESS longer triggers a one-shot "
                "diagnostic state dump (collective, algorithm, round, "
                "outstanding peers/tags, team state positions); 0 = off",
                parse_string),
    ConfigField("WATCHDOG_FILE", "ucc_watchdog.json", "watchdog state-dump "
                "file (JSON lines)", parse_string),
    ConfigField("WATCHDOG_ACTION", "dump", "escalation ladder: dump = "
                "diagnose only; cancel = also cancel tasks stuck past the "
                "hard deadline with ERR_TIMED_OUT (unwinds posted transport "
                "ops); abort = cancel EVERY in-flight task once one "
                "crosses the hard deadline and fail stalled team creates",
                parse_string),
    ConfigField("WATCHDOG_HARD_TIMEOUT", "0", "hard deadline in seconds "
                "for the cancel/abort watchdog actions (0 = 2x "
                "WATCHDOG_TIMEOUT)", parse_string),
    ConfigField("FAULT", "", "fault-injection spec (deterministic failure "
                "drills): drop=P,delay=P:S,delay_rank=R,error=P,"
                "post_error=P,kill=R[+R..],corrupt=P,corrupt_rank=R; "
                "empty = off (zero cost)", parse_string),
    ConfigField("FAULT_SEED", "0", "RNG seed for UCC_FAULT decisions: the "
                "same seed + spec replays the same drill", parse_string),
    ConfigField("FT", "none", "rank-failure recovery mode: none = failures "
                "are bounded but terminal (zero cost); shrink = peer "
                "liveness + failure agreement + Team.shrink: survivors "
                "observe ERR_RANK_FAILED naming the dead ranks, agree on "
                "the failed set and recovery epoch, and rebuild the team "
                "without them (old-epoch traffic is fenced at the "
                "transport)", parse_string),
    ConfigField("HEARTBEAT_INTERVAL", "0.05", "seconds between liveness "
                "heartbeats published from each context's progress loop "
                "(UCC_FT=shrink only)", parse_string),
    ConfigField("HEARTBEAT_TIMEOUT", "2.0", "seconds without a peer "
                "heartbeat before the peer is declared failed and "
                "in-flight collectives depending on it are cancelled "
                "with ERR_RANK_FAILED (UCC_FT=shrink only)",
                parse_string),
    ConfigField("FT_GROW_TIMEOUT", "30.0", "seconds a Team.grow waits for "
                "every invited joiner to bootstrap before rolling back "
                "(ERR_TIMED_OUT naming the absent joiner; the pre-grow "
                "team stays usable)", parse_string),
    ConfigField("FT_AGREE_GRACE", "3", "bounded deadline extensions a "
                "fault-agreement round grants a pending peer whose "
                "heartbeat is still fresh: slow but live ranks are not "
                "condemned by the round timer alone (0 = the timer "
                "alone)", parse_string),
    ConfigField("OOB_CONNECT_BACKOFF_BASE", "0.05", "initial TCP-store OOB "
                "connect retry backoff in seconds (exponential, full "
                "jitter)", parse_string),
    ConfigField("OOB_CONNECT_BACKOFF_MAX", "2.0", "TCP-store OOB connect "
                "retry backoff cap in seconds", parse_string),
    ConfigField("OOB_BOOTSTRAP_TIMEOUT", "120", "TCP-store OOB server-side "
                "bootstrap deadline in seconds: after it, registered "
                "ranks are failed with ERR_TIMED_OUT naming the absent "
                "ranks instead of hanging the job (<=0 = wait forever)",
                parse_string),
    ConfigField("OOB_TREE", "auto", "bootstrap store topology: n = one "
                "flat store every rank connects to (O(n) server fan-in); "
                "y = tree-structured exchange (per-node leader stores + "
                "radix-bounded parent stores, O(log n) rounds and "
                "max(ppn, radix) fan-in per server; every store binds "
                "the coordinator host, so y asserts a single-host job); "
                "auto = tree from OOB_TREE_THRESH ranks up, loopback "
                "coordinators only", parse_string),
    ConfigField("OOB_TREE_PPN", "", "ranks-per-node shape of the "
                "bootstrap tree: an int (nodes of N) or a cyclic comma "
                "list of node sizes; empty = ranks_per_proc under "
                "bootstrap.World, else radix-sized blocks", parse_string),
    ConfigField("OOB_TREE_RADIX", "8", "max members per upper-level "
                "bootstrap store (leader-of-leaders group size)",
                parse_string),
    ConfigField("OOB_TREE_THRESH", "32", "team size from which "
                "UCC_OOB_TREE=auto switches the TCP bootstrap onto the "
                "tree exchange", parse_string),
    # read from the environment by topo/proc_info.py at context create;
    # listed here so config dumps document them
    ConfigField("TOPO_FAKE_PPN", "", "simulated topology: group context "
                "ranks into virtual nodes — an int N (nodes of N) or a "
                "cyclic comma list of node sizes (\"2,1,3\") for "
                "asymmetric layouts; empty = real host detection",
                parse_string),
    ConfigField("TOPO_FAKE_NODES_PER_POD", "", "simulated topology: "
                "group every M consecutive virtual nodes into a DCN pod "
                "(activates the 3-level chip->node->pod hierarchy tree "
                "in CL/HIER); empty = no pod grouping", parse_string),
    ConfigField("TEAM_IDS_POOL_SIZE", "32", "team id pool size per context",
                parse_uint),
    ConfigField("CHECK_ASYMMETRIC_DT", "n", "validate datatype and memory "
                "type consistency of rooted collectives (gather(v), "
                "scatter(v), bcast, reduce) with a service allreduce before "
                "the collective; needs a multi-rank service team (tl/shm). "
                "Off by default, as in UCC", parse_bool),
    # read from the environment at import by schedule/progress.py,
    # core/team.py and core/coalesce.py (off costs nothing); listed here so
    # config dumps document them
    ConfigField("TEAM_PRIORITY", "1", "default QoS priority class for teams "
                "created without an explicit TeamParams.priority: 0 = bulk "
                "(lowest) .. 3 = latency (highest); selects the "
                "progress-queue lane every task of the team drains from",
                parse_string),
    ConfigField("QOS_WEIGHTS", "1,2,4,8", "per-lane weighted-round-robin "
                "caps (services per progress pass while a higher lane is "
                "non-empty, lane 0 first); the top non-empty lane is never "
                "capped", parse_string),
    ConfigField("QOS_AGE_MS", "10", "anti-starvation bound in milliseconds: "
                "a queued task older than this is serviced regardless of "
                "its lane's WRR cap, and deferrable bulk work (coalesced "
                "dispatch) stops yielding to latency traffic",
                parse_string),
    ConfigField("COALESCE", "n", "small-collective coalescing: same-team "
                "eligible HOST allreduces (contiguous, same op/dtype, <= "
                "COALESCE_LIMIT bytes each) posted within a window are "
                "packed into ONE fused generated collective (a native plan "
                "when the core is built) and unpacked to per-request "
                "statuses on completion; n (default) = zero cost, posts "
                "unchanged", parse_bool),
    ConfigField("COALESCE_LIMIT", "4096", "per-member payload ceiling in "
                "bytes for coalescing; above it a collective is "
                "bandwidth-bound and batching only adds a copy",
                parse_string),
    ConfigField("COALESCE_WINDOW", "200", "gather window in microseconds "
                "before a non-full batch flushes (any closure trigger: "
                "batch full, ineligible post, test() on a held member, "
                "flushes earlier; this is only the quiescent-rank valve)",
                parse_string),
    ConfigField("COALESCE_MAX_BATCH", "16", "deterministic batch-size cap, "
                "the primary closure trigger: every rank flushes on the "
                "Nth eligible post, keeping fused membership identical "
                "across ranks in program order", parse_string),
    ConfigField("TUNER", "off", "measurement-driven algorithm selection "
                "(score/tuner.py): off = static score map only (no "
                "dispatch branches); offline = load the topology-keyed "
                "tuning cache (written by ucc_tune, perftest --sweep "
                "compilations or earlier online runs) at team activation; "
                "online = also explore live candidates during the first "
                "TUNER_SAMPLES posts per (coll, mem, size-bucket), freeze "
                "the rank-0 winner team-wide over the service team, and "
                "persist it to the cache",
                parse_enum(("off", "offline", "online"))),
    ConfigField("TUNER_SAMPLES", "8", "online exploration budget: tuned "
                "posts per (coll, mem, size-bucket) before every rank "
                "posts the decision bcast and freezes rank 0's measured "
                "winner", parse_uint),
    ConfigField("TUNER_CACHE", "", "tuning-cache file (JSON keyed by the "
                "topology signature: team size, node layout, TL set, "
                "thread mode); empty = ~/.cache/ucc_tpu_torch/tune.json",
                parse_string),
    # the lib fields the quantized and generated device collectives read
    # (quant/, dsl/),
    # with the JAX package's defaults
    ConfigField("QUANT", "off", "block-scaled wire precision for eligible "
                "collectives (allreduce/allgather, float32/bfloat16 "
                "payloads): off = exact only (candidate lists "
                "unchanged); int8/fp8 = register the quantized variants "
                "of tl/shm and tl/torch_ops", parse_enum(("off", "int8",
                                                          "fp8"))),
    ConfigField("QUANT_ALLREDUCE", "", "per-collective precision override "
                "for allreduce (off|int8|fp8; empty = inherit UCC_QUANT)",
                parse_string),
    ConfigField("QUANT_ALLGATHER", "", "per-collective precision override "
                "for allgather (off|int8|fp8; empty = inherit UCC_QUANT)",
                parse_string),
    ConfigField("QUANT_BLOCK", "256", "elements per absmax scale block of "
                "the quantized wire format", parse_uint),
    ConfigField("QUANT_ERROR_BUDGET", "auto", "max tolerated relative "
                "error (fraction of the per-block absmax) of quantized "
                "candidates; auto = admit the selected precision (int8: "
                "0.1, fp8: 1.0); an explicit float gates strictly",
                parse_string),
    ConfigField("QUANT_STOCHASTIC", "n", "stochastic rounding in the int8 "
                "host encoder (the generated device programs refuse it)",
                parse_bool),
    ConfigField("GEN", "n", "collective compiler (dsl/): y = generate, "
                "statically verify and register the DSL's program families "
                "(ring chunking, recursive halving/doubling radix, SRA "
                "pipeline depth, fused allreduce+quantize, the pooled and "
                "hierarchical programs) as low-score tuner-explorable "
                "candidates of the host TLs with origin 'generated'; n "
                "(default) = candidate lists unchanged", parse_bool),
    ConfigField("GEN_FAMILIES", "", "generated families and parameter "
                "grids, e.g. 'ring(1,2,4),rhd(2,8),sra_pipe(2),qdirect' — "
                "empty = every built-in family at its default grid; "
                "programs failing the static verifier or inapplicable at "
                "the team size are skipped", parse_string),
    ConfigField("GEN_SEARCH", "y", "register persisted search winners "
                "(dsl/search.py, written by `ucc_tune --gen-search`) from "
                "the search cache as candidates with origin 'searched'; "
                "needs UCC_GEN=y; costs nothing when the cache has no "
                "entries for this (team size, topology)", parse_bool),
    ConfigField("GEN_SEARCH_CACHE", "", "search-cache file (JSON: searched "
                "program specs with predicted and measured cost); empty = "
                "~/.cache/ucc_tpu_torch/search.json (read from the "
                "environment)", parse_string),
    ConfigField("GEN_SEARCH_BUDGET", "10", "cost-model shortlist size per "
                "(collective, message size) point: the search measures at "
                "most this many predicted-cheapest candidates by "
                "successive halving", parse_uint),
    ConfigField("GEN_PROG_CACHE", "", "verified-program disk cache "
                "(pickle of the port's own program objects, keyed by "
                "family, parameters, team size, topology and DSL_VERSION); "
                "empty = ~/.cache/ucc_tpu_torch/programs.pkl, 0/n = off "
                "(read from the environment)", parse_string),
    ConfigField("GEN_COST_CACHE", "", "fitted alpha-beta cost-model file "
                "(JSON, written by `ucc_tune --gen-search`); empty = "
                "~/.cache/ucc_tpu_torch/cost.json (read from the "
                "environment)", parse_string),
    ConfigField("GEN_NATIVE", "auto", "native execution plans: lower a "
                "verified allreduce program (the generated families and "
                "the hand-written ring/sra bridges) to a packed op table "
                "that the native core retires — one ffi crossing per "
                "collective, C-side f32/f64 reductions. auto = on when "
                "the native matcher serves every endpoint of the team and "
                "the dtype/op runs fully native, else interpret; y also "
                "routes assist rounds (bf16, quantized wire) through "
                "plans and raises ERR_NO_RESOURCE when a plan cannot be "
                "built; n = always interpret. Plan rows show '+plan' in "
                "the score dump", parse_string),
    ConfigField("POOL_ENABLE", "auto", "pooled (one-sided put+flag window) "
                "variants of the generated families: auto = whatever "
                "UCC_GEN_FAMILIES produced; n drops them; y adds them at "
                "their grid when the spec left them out. Needs UCC_GEN=y "
                "and an arena-backed (tl/ipc) team", parse_string),
    ConfigField("POOL_CHUNKS", "", "chunk-count grid of the pooled "
                "variants, e.g. '1,2,4' (default grid 1,2)", parse_string),
    ConfigField("GEN_DEVICE", "n", "generated device collectives "
                "(dsl/lower_device): y = lower verified DSL programs "
                "(ring/rhd/bcast families plus the quantized direct "
                "exchange under UCC_QUANT) to candidates of tl/torch_ops "
                "named gen_dev_*, origin 'generated-device', at a low "
                "score; n (default) keeps candidate lists unchanged",
                parse_string),
    ConfigField("GEN_DEVICE_FAMILIES", "", "device families and "
                "parameter grids, e.g. 'ring(1,2,4),rhd(2,0),bc_kn(2,0),"
                "bc_chain(2),qdirect'; empty = the default grid",
                parse_string),
    ConfigField("GEN_DEVICE_BACKEND", "auto", "backend of the generated "
                "device collectives: auto and pallas = the CUDA kernel of "
                "kernels/gen_device.py on a CUDA team, xla = the layer "
                "plan as torch ops; a cpu team runs the plain version",
                parse_string),
]))


class TlLib:
    """One loaded TL component within a Lib."""

    def __init__(self, lib: "Lib", tl_cls):
        self.lib = lib
        self.tl_cls = tl_cls
        cfg = lib.component_config(tl_cls.LIB_CONFIG)
        self.obj = tl_cls.lib_cls(lib, cfg)

    @property
    def name(self) -> str:
        return self.tl_cls.NAME


class ClLib:
    """One loaded CL component."""

    def __init__(self, lib: "Lib", cl_cls):
        self.lib = lib
        self.cl_cls = cl_cls
        cfg = lib.component_config(cl_cls.LIB_CONFIG)
        self.obj = cl_cls.lib_cls(lib, cfg)

    @property
    def name(self) -> str:
        return self.cl_cls.NAME


class Lib:
    """ucc_lib_h."""

    def __init__(self, params: Optional[LibParams] = None,
                 config_overrides: Optional[Dict[str, str]] = None):
        self.params = params or LibParams()
        discover_components()
        self.config_overrides = dict(config_overrides or {})
        self.config = Config(GLOBAL_CONFIG, overrides=config_overrides)

        cls_req: List[str] = self.config.cls
        if cls_req == ["all"]:
            cls_req = available_cls()
        tls_allow: List[str] = self.config.tls
        if tls_allow == ["all"]:
            tls_allow = available_tls()

        self.cl_libs: List[ClLib] = []
        self.tl_libs: Dict[str, TlLib] = {}
        for cl_name in cls_req:
            try:
                cl_cls = get_cl(cl_name)
            except UccError:
                logger.warning("requested CL '%s' not available", cl_name)
                continue
            cl_lib = ClLib(self, cl_cls)
            self.cl_libs.append(cl_lib)
            wanted = cl_cls.REQUIRED_TLS
            if wanted is None:
                wanted = tls_allow
            for tl_name in wanted:
                if tl_name not in tls_allow or tl_name in self.tl_libs:
                    continue
                try:
                    tl_cls = get_tl(tl_name)
                except UccError:
                    logger.warning("TL '%s' not available", tl_name)
                    continue
                self.tl_libs[tl_name] = TlLib(self, tl_cls)
        if not self.cl_libs:
            raise UccError(Status.ERR_NOT_FOUND,
                           f"no usable CL among {cls_req}")

        coll_union = CollType(0)
        for tl in self.tl_libs.values():
            coll_union |= tl.tl_cls.SUPPORTED_COLLS
        self.attr = LibAttr(thread_mode=self.params.thread_mode,
                            coll_types=coll_union or COLL_TYPE_ALL)
        self._finalized = False
        logger.info("ucc_tpu_torch lib init: cls=%s tls=%s",
                    [c.name for c in self.cl_libs], list(self.tl_libs))

    def component_config(self, table: Optional[ConfigTable]
                         ) -> Optional[Config]:
        """A component's config (None without a table): its environment
        variables, overridden by this lib's overrides that carry the
        table's prefix, e.g. ``init(TL_RING_CUDA_DEVICE="cpu")`` sets the
        DEVICE of every device TL's context config."""
        if table is None:
            return None
        own = {k[len(table.prefix):]: v
               for k, v in self.config_overrides.items()
               if table.prefix and k.startswith(table.prefix)}
        return Config(table, overrides=own or None)

    # ------------------------------------------------------------------
    def get_attr(self) -> LibAttr:
        return self.attr

    def finalize(self) -> Status:
        self._finalized = True
        return Status.OK


def init(params: Optional[LibParams] = None, **overrides) -> Lib:
    """ucc_init. Each override names a config field without ``UCC_``: a
    global field (``TLS="ring_cuda,torch_ops"``) or a component's, prefix
    included (``TL_RING_CUDA_DEVICE="cpu"``); it wins over the
    environment."""
    return Lib(params, config_overrides=overrides or None)
