// ucc_tpu_torch native runtime core — v2 (ABI 6): the port's own copy
// of the JAX package's tag-matching core, built by ucc_tpu_torch/native.py
// into ucc_tpu_torch/build/ as libucc_tpu_torch_core.so. The C API and
// kAbiVersion are those of the original; the plan functions are kept
// (the file is self-contained) but nothing in the port binds them yet.
//
//
// The host-side hot paths of the framework, in C++ (the role the reference's
// C core plays for its progress engine and UCX's matching engine plays for
// tl/ucp — SURVEY §2.5, tl_ucp_sendrecv.h):
//
//   * tagged-message mailbox with FULL parity to the Python
//     tl/host/transport.Mailbox contract:
//       - copy-free delivery: a push that finds a matching posted recv
//         memcpys sender -> dst directly under the shard lock (no owned
//         staging vector); unexpected sends take the classic eager copy
//         (<= eager_limit) or park a zero-copy rendezvous pointer whose
//         buffer the Python caller keeps alive.
//       - fixed-width binary tag keys: three packed u64 words
//         (team_id<<32|epoch, coll_tag, slot<<32|src) — hashing is a few
//         word multiplies, no serialized Python keys.
//       - epoch fences (ucc_mailbox_fence): parked stale entries are
//         purged and LATE stale arrivals are discarded at the match
//         boundary, so UCC_FT=shrink runs on the native matcher.
//       - cancelled-entry skip (ucc_req_cancel): withdrawn recvs are
//         skipped at match time under the same shard lock that delivers,
//         so cancel-vs-match cannot interleave (PR-2 recv withdrawal and
//         the PR-3/PR-4 lease-taint invariants hold natively).
//       - truncation contract: a send larger than the recv capacity is
//         clamped and flagged; the sender's total size is kept for the
//         error text (cf. UCS_ERR_MESSAGE_TRUNCATED).
//   * GIL-free completion polling: request state is published into a
//     flat "pub" array of u64 words (gen<<32 | nbytes<<3 | state) that
//     the Python side maps once and reads directly — the poll path costs
//     a memory load, not an ffi call. ucc_req_test_many batch-polls N
//     requests in one call for callers without the mapping.
//   * request table: generation-counted slots in on-demand chunks. Send
//     requests are freed AT DELIVERY (a bumped generation reads as
//     complete), recv requests by their owner at completion, and
//     ucc_mailbox_purge reclaims everything else at endpoint teardown —
//     abandoned requests no longer leak until mailbox destroy.
//   * bounded MPMC queue (the ucc_lock_free_queue.h analog) for
//     multi-threaded producers/consumers of task handles.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image);
// ucc_abi_version() lets the loader reject a stale build instead of
// symbol-probing. Handle-based API: requests are u64 ids packed as
// (generation<<20 | slot index).

#ifdef UCC_TPU_PY_EXT
// Python.h must precede every other include (it defines feature-test
// macros). The extension build (ucc_tpu_core_ext.so, -DUCC_TPU_EXT_THIN)
// compiles ONLY the METH_FASTCALL wrappers around the two per-message
// hot calls and links against libucc_tpu_core.so — ctypes argument
// marshalling was the largest single cost on the single-threaded path.
// The plain-C build stays the ctypes fallback; both speak the same ABI
// version.
#include <Python.h>
#endif

#include <atomic>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {
// visible to BOTH artifacts: the loader's ABI gate compares the ext's
// compiled-in value (py_abi_version) against the core's ucc_abi_version()
// (4: native execution plans — ucc_plan_build/post/test/cancel retire a
// verified DSL program's whole round schedule against the mailbox in C++;
// 5: wire integrity — per-entry crc32 word, kCorrupt completion state,
// ucc_mailbox_set_integrity / ucc_mailbox_push2;
// 6: cross-process shared-memory arenas — ucc_mailbox_attach and the
// ucc_ipc_*/ucc_arena_* surface in ucc_tpu_ipc.cc: the tag-match
// structures, completion-publication slots and payload heap live in one
// mmap'd POSIX shm segment per node, so ranks in different processes
// match and deliver with the same direct/eager/rndv/fenced contracts as
// the in-process mailbox)
constexpr uint64_t kAbiVersion = 6;
}  // namespace

// The thin extension build (-DUCC_TPU_EXT_THIN) compiles ONLY the CPython
// module at the bottom and links against libucc_tpu_core.so, so exactly
// one copy of the matcher code (and its struct layouts) exists in the
// process by construction.
#ifndef UCC_TPU_EXT_THIN

namespace {

constexpr uint32_t kSlotBits = 20;
constexpr uint32_t kMaxSlots = 1u << kSlotBits;      // 1M live requests
constexpr uint32_t kIdxMask = kMaxSlots - 1;
constexpr uint32_t kChunkBits = 12;
constexpr uint32_t kChunkSize = 1u << kChunkBits;
constexpr uint32_t kMaxChunks = kMaxSlots >> kChunkBits;
constexpr int kShards = 16;

// pub word: (gen << 32) | (min(nbytes, kNbMax) << 3) | state. nbytes
// saturates at kNbMax (512MB-1); saturated readers fall back to
// ucc_req_nbytes.
constexpr uint64_t kNbMax = (1ull << 29) - 1;

enum State : uint32_t {
    kPending = 0,
    kOk = 1,
    kTruncated = 2,   // matched send exceeded dst capacity (clamped)
    kFenced = 3,      // stale team epoch at the match boundary
    kCanceled = 4,    // withdrawn by ucc_req_cancel
    kAssist = 5,      // plan state word only: python assist callback due
    kCorrupt = 6,     // wire crc32 mismatch at delivery; the pub word's
                      // nbytes field carries the SENDER's ctx rank
};

// push() return kinds, packed into the low 3 bits of the return word
// (rndv additionally carries the send request id in the high bits)
enum Kind : uint32_t {
    kKindDirect = 0,
    kKindEager = 1,
    kKindRndv = 2,
    kKindFenced = 3,
};

struct Key {
    uint64_t a, b, c;   // team_id<<32|epoch, coll_tag, slot<<32|src
    bool operator==(const Key& o) const {
        return a == o.a && b == o.b && c == o.c;
    }
};

struct KeyHash {
    size_t operator()(const Key& k) const {
        uint64_t h = k.a * 0x9E3779B97F4A7C15ull;
        h ^= k.b + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2);
        h *= 0xBF58476D1CE4E5B9ull;
        h ^= k.c + (h << 6) + (h >> 2);
        return static_cast<size_t>(h ^ (h >> 31));
    }
};

struct Slot {
    std::atomic<uint32_t> gen{0};   // odd = live; bumped on alloc AND free
    uint32_t shard = 0;             // recv: shard index (for cancel)
    uint64_t nbytes = 0;            // recv: delivered bytes
    uint64_t sent = 0;              // recv: matched send's TOTAL bytes
    void* dst = nullptr;            // recv destination
    uint64_t cap = 0;               // recv capacity
    void* plan = nullptr;           // owning execution plan (nudge target)
};

// parked unexpected send (the _PendingSend analog)
struct Unexp {
    std::vector<uint8_t> owned;     // eager staging copy (empty for rndv)
    const void* ptr = nullptr;      // rndv payload (caller keeps it alive)
    uint64_t len = 0;
    uint64_t sreq = 0;              // rndv send request id (0 = eager)
    void* src_plan = nullptr;       // sending plan (nudged at delivery)
    uint64_t crc = 0;               // checksum word: (1<<32)|crc32, 0=none
};

struct Shard {
    std::mutex mu;
    std::unordered_map<Key, std::deque<Unexp>, KeyHash> unexpected;
    std::unordered_map<Key, std::deque<uint64_t>, KeyHash> posted;
    // team_id -> minimum accepted epoch. Kept PER SHARD and read/written
    // only under this shard's mu, so the fence-vs-push race needs no
    // extra lock on the hot path: whichever takes the shard lock second
    // sees the other's effect (the Python Mailbox gets the same property
    // from its single lock). Empty (the UCC_FT=none steady state) costs
    // one branch per message.
    std::unordered_map<uint32_t, uint32_t> fences;
};

struct Mailbox {
    Shard shards[kShards];

    // wire-integrity arming (UCC_INTEGRITY=wire|verify): when nonzero,
    // pushes without a caller-supplied checksum compute a crc32 over the
    // payload and every delivery verifies it. Cold default: the single
    // relaxed load in push_impl is the entire off-mode cost.
    std::atomic<uint32_t> integrity{0};

    // request table: chunked slots + flat pub array (Python maps pub once)
    std::atomic<Slot*> chunks[kMaxChunks];
    std::atomic<uint64_t>* pub;
    std::mutex alloc_mu;
    std::vector<uint32_t> free_list;
    uint32_t next_slot = 0;

    Mailbox() {
        for (auto& c : chunks) c.store(nullptr, std::memory_order_relaxed);
        // default-init: trivial ctors, so the 8MB stays untouched virtual
        // memory until slots are actually allocated
        pub = new std::atomic<uint64_t>[kMaxSlots];
    }

    ~Mailbox() {
        for (auto& c : chunks) delete[] c.load(std::memory_order_relaxed);
        delete[] pub;
    }

    Shard& shard_for(const Key& k, uint32_t* idx_out) {
        uint32_t i = static_cast<uint32_t>(KeyHash{}(k) % kShards);
        *idx_out = i;
        return shards[i];
    }

    Slot* slot_of(uint32_t idx) {
        if (idx >= kMaxSlots) return nullptr;
        Slot* c = chunks[idx >> kChunkBits].load(std::memory_order_acquire);
        return c ? &c[idx & (kChunkSize - 1)] : nullptr;
    }

    // Allocate a live slot; returns the request id (0 on exhaustion).
    uint64_t alloc(Slot** out) {
        std::lock_guard<std::mutex> g(alloc_mu);
        uint32_t idx;
        if (!free_list.empty()) {
            idx = free_list.back();
            free_list.pop_back();
        } else {
            if (next_slot >= kMaxSlots) return 0;
            idx = next_slot++;
            uint32_t ch = idx >> kChunkBits;
            if (chunks[ch].load(std::memory_order_relaxed) == nullptr)
                chunks[ch].store(new Slot[kChunkSize],
                                 std::memory_order_release);
        }
        Slot* s = slot_of(idx);
        uint32_t gen = s->gen.load(std::memory_order_relaxed) + 1;  // odd
        s->gen.store(gen, std::memory_order_relaxed);
        s->shard = 0;
        s->nbytes = 0;
        s->sent = 0;
        s->dst = nullptr;
        s->cap = 0;
        s->plan = nullptr;
        pub[idx].store(static_cast<uint64_t>(gen) << 32,
                       std::memory_order_release);
        *out = s;
        return (static_cast<uint64_t>(gen) << kSlotBits) | idx;
    }

    // Validated free: no-op unless *rid* still names the live generation,
    // so owner-free, delivery-free and purge can race without double-free.
    void free_rid(uint64_t rid) {
        uint32_t idx = static_cast<uint32_t>(rid & kIdxMask);
        uint32_t gen = static_cast<uint32_t>(rid >> kSlotBits);
        std::lock_guard<std::mutex> g(alloc_mu);
        Slot* s = slot_of(idx);
        if (s == nullptr || s->gen.load(std::memory_order_relaxed) != gen)
            return;
        uint32_t ng = gen + 1;   // even: free; readers of the old rid see
        s->gen.store(ng, std::memory_order_relaxed);   // "freed == done"
        pub[idx].store(static_cast<uint64_t>(ng) << 32,
                       std::memory_order_release);
        free_list.push_back(idx);
    }

    // Live-and-pending check for a parked recv id (cancel/fence/free skip).
    Slot* live_pending(uint64_t rid) {
        uint32_t idx = static_cast<uint32_t>(rid & kIdxMask);
        Slot* s = slot_of(idx);
        if (s == nullptr) return nullptr;
        uint64_t v = pub[idx].load(std::memory_order_acquire);
        if ((v >> 32) != (rid >> kSlotBits) || (v & 7u) != 0) return nullptr;
        return s;
    }

    void publish(uint64_t rid, uint64_t nbytes, uint32_t state) {
        uint32_t idx = static_cast<uint32_t>(rid & kIdxMask);
        uint64_t nb = nbytes > kNbMax ? kNbMax : nbytes;
        pub[idx].store(((rid >> kSlotBits) << 32) | (nb << 3) | state,
                       std::memory_order_release);
    }

    bool is_fenced(Shard& sh, const Key& k) {
        auto it = sh.fences.find(static_cast<uint32_t>(k.a >> 32));
        return it != sh.fences.end() &&
               static_cast<uint32_t>(k.a) < it->second;
    }
};

// software crc32 (reflected, polynomial 0xEDB88320) — bit-identical to
// zlib.crc32, so checksums computed here interoperate with the python
// matcher's and with injector-supplied clean checksums.
struct Crc32Table {
    uint32_t t[256];
    Crc32Table() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k)
                c = (c & 1u) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
            t[i] = c;
        }
    }
};

uint32_t crc32_of(const void* data, uint64_t len) {
    static const Crc32Table tab;
    const uint8_t* p = static_cast<const uint8_t*>(data);
    uint32_t crc = 0xFFFFFFFFu;
    for (uint64_t i = 0; i < len; ++i)
        crc = tab.t[(crc ^ p[i]) & 0xFFu] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

// poll word relative to *rid*: 0 = pending; else (nbytes<<3)|state, with
// a freed/reused slot reading as plain done-OK (only non-owners — rndv
// senders, whose requests are freed at delivery — ever observe that).
uint64_t poll_rid(Mailbox* mb, uint64_t rid) {
    uint32_t idx = static_cast<uint32_t>(rid & kIdxMask);
    if (idx >= kMaxSlots) return kOk;
    uint64_t v = mb->pub[idx].load(std::memory_order_acquire);
    if ((v >> 32) != (rid >> kSlotBits)) return kOk;   // freed == complete
    return v & 0xFFFFFFFFull;
}

// Destroyed mailboxes are PARKED here and recycled by the next create,
// never deleted: a Python thread that loaded the mailbox pointer (or its
// mapped pub array) just before a concurrent destroy may still poll it,
// and the generation bumps done by the destroy-time purge make every
// such stale poll read "freed == complete" instead of touching freed
// heap. Memory cost is bounded by the high-water mark of live mailboxes
// (one per endpoint), and the pub array is lazily-paged virtual memory.
std::mutex g_park_mu;
std::vector<Mailbox*> g_parked;

// ---------------------------------------------------------------------------
// native execution plans — a verified DSL program's per-rank stream,
// lowered by ucc_tpu/dsl/plan.py to a packed op table and retired here
// entirely in C++: one ffi crossing posts the plan, rounds advance
// delivery-driven (the thread that completes a round's last message
// advances the owning plan), reductions run in C, and the owner polls a
// single completion word in the mapped pub window. Python re-enters only
// for per-plan "assist" rounds (non-f32/f64 reduces, quantized codec
// edges) flagged at build time.
// ---------------------------------------------------------------------------

// packed op entry: 8 u64 words (dsl/plan.py PLAN_OP_WORDS must match):
//   w0 = kind | (flags << 8)           flags on WAIT_ROUND: 1 = pre-assist
//                                      (python runs ENCODE before sends),
//                                      2 = post-assist (python runs the
//                                      round's REDUCE/COPY/DECODE)
//   w1 = key word a of the TARGET mailbox (team_id<<32 | epoch)
//   w2 = key word c (slot<<32 | src ctx rank)
//   w3 = peer index into the peer-mailbox array (sends only)
//   w4 = dst region | src region<<4 | dtype<<8 | reduce op<<16
//        regions: 0 = user dst vector (rebased every post), 1 = plan
//        scratch (mc-pool lease, fixed for the plan's lifetime)
//   w5 = dst byte offset
//   w6 = src byte offset (REDUCE landing zone / COPY source)
//   w7 = nbytes
// Key word b (the per-post collective tag) is patched in at post time so
// a cached plan survives persistent re-posts and tag-space advancement.
enum PlanOpKind : uint32_t {
    kOpPostSend = 0,
    kOpPostRecv = 1,
    kOpWaitRound = 2,
    kOpReduce = 3,
    kOpCopy = 4,
    kOpEncode = 5,    // python-assist only: C validates + skips
    kOpDecode = 6,    // python-assist only: C validates + skips
};

constexpr uint64_t kPlanOpWords = 8;
constexpr uint32_t kPlanFlagPreAssist = 1;
constexpr uint32_t kPlanFlagPostAssist = 2;

enum PlanStage : uint32_t {
    kPlanIdle = 0,
    kPlanPostRecvs,
    kPlanPreAssist,    // waiting for ucc_plan_assist_done (encode phase)
    kPlanPostSends,
    kPlanWait,
    kPlanPostAssist,   // waiting for ucc_plan_assist_done (local phase)
    kPlanDone,
};

struct PlanWireOp {
    uint64_t key_a = 0, key_c = 0;
    uint32_t peer = 0;       // index into Plan::peers (sends)
    uint32_t region = 0;
    uint64_t off = 0, nbytes = 0;
};

struct PlanLocalOp {
    uint32_t kind = 0, dtype = 0, rop = 0;
    uint32_t region_dst = 0, region_src = 0;
    uint64_t off_dst = 0, off_src = 0, nbytes = 0;
};

struct PlanRound {
    std::vector<PlanWireOp> sends, recvs;
    std::vector<PlanLocalOp> locals;
    bool pre_assist = false, post_assist = false;
};

struct PendingReq {
    Mailbox* mb;      // rndv send rids live in the PEER's slot table
    uint64_t rid;
    bool recv;
};

struct Plan {
    std::mutex mu;
    Mailbox* mb = nullptr;               // my (receiving) mailbox
    std::vector<Mailbox*> peers;
    std::vector<PlanRound> rounds;
    std::vector<PendingReq> pending;     // current round's live requests
    uint64_t state_rid = 0;              // completion word in mb's pub map
    uint64_t eager_limit = 0;
    uint8_t* user_base = nullptr;        // rebased every post
    uint8_t* scratch_base = nullptr;     // plan-lifetime mc-pool lease
    uint64_t tag = 0;                    // key word b, patched per post
    uint32_t round = 0;
    uint32_t stage = kPlanIdle;
    bool live = false;
    bool canceled = false;
    bool parked = false;
    // accounting, mapped read-only by python after an acquire-ordered
    // confirm of the state word: [0..3] send kinds direct/eager/rndv/
    // fenced, [4] rounds completed, [5] recvs withdrawn by cancel,
    // [6] corrupt deliveries, [7] first corrupt sender's ctx rank + 1
    uint64_t ctr[8] = {0};
};

// data-path ffi crossings (ucc_plan_post/test/assist_done): the debug
// counter the CI plans-smoke reads to prove crossings-per-collective==1
std::atomic<uint64_t> g_plan_ffi{0};

std::mutex g_plan_park_mu;
std::vector<Plan*> g_plan_parked;   // parked like mailboxes, never freed

void plan_advance(Plan* p);

// Delivery-driven advancement without lock-order inversion: completions
// discovered while holding a shard (or plan) lock only ENQUEUE the plan;
// the outermost C entry point drains the thread-local list with no locks
// held. Plan mutexes therefore never nest (plan.mu > shard.mu >
// alloc_mu is the only lock order), and a cascade across many ranks
// runs as a loop, not recursion.
thread_local std::vector<Plan*> t_plan_ready;
thread_local bool t_plan_drain = false;

void plan_enqueue(void* pv) {
    if (pv != nullptr) t_plan_ready.push_back(static_cast<Plan*>(pv));
}

void plan_ready(void* pv) {
    plan_enqueue(pv);
    if (t_plan_drain) return;
    t_plan_drain = true;
    while (!t_plan_ready.empty()) {
        Plan* q = t_plan_ready.back();
        t_plan_ready.pop_back();
        plan_advance(q);
    }
    t_plan_drain = false;
}

// shared matcher core of ucc_mailbox_push and the plan executor's send
// pass: *nudge is set to the receiving plan on a direct delivery into a
// plan-posted recv; *src_plan* rides parked rndv entries so the sender's
// plan is nudged when a later recv lands the message. *crcw* is the
// checksum word ((1<<32)|crc32 of the payload, 0 = unchecked): when the
// receiving mailbox has integrity armed and the caller supplied none,
// one is computed here — that single path covers python pushes AND every
// plan-executor round. Verification happens at delivery (direct here,
// parked entries in post_recv_impl); a mismatch publishes kCorrupt with
// the sender's ctx rank (low word of key c) in the nbytes field, and the
// SEND still completes normally — corruption is the receiver's error,
// exactly like the python matcher.
uint64_t push_impl(Mailbox* mb, const Key& k, const void* data,
                   uint64_t len, uint64_t eager_limit, uint64_t crcw,
                   void* src_plan, void** nudge) {
    *nudge = nullptr;
    if ((crcw >> 32) == 0 &&
        mb->integrity.load(std::memory_order_relaxed))
        crcw = (1ull << 32) | crc32_of(data, len);
    uint32_t shard_idx;
    Shard& sh = mb->shard_for(k, &shard_idx);
    std::lock_guard<std::mutex> g(sh.mu);
    if (!sh.fences.empty() && mb->is_fenced(sh, k)) return kKindFenced;
    auto it = sh.posted.find(k);
    if (it != sh.posted.end()) {
        auto& dq = it->second;
        uint64_t rid = 0;
        Slot* s = nullptr;
        while (!dq.empty()) {
            rid = dq.front();
            dq.pop_front();
            s = mb->live_pending(rid);   // cancelled-entry skip
            if (s != nullptr) break;
        }
        if (dq.empty()) sh.posted.erase(it);
        if (s != nullptr) {
            // copy-free delivery: sender buffer -> posted dst, under the
            // shard lock (cancel takes the same lock, so a recv cannot be
            // withdrawn between being matched and being written)
            uint64_t n = len < s->cap ? len : s->cap;
            if (n) std::memcpy(s->dst, data, n);
            s->nbytes = n;
            s->sent = len;
            *nudge = s->plan;
            if ((crcw >> 32) && len <= s->cap &&
                crc32_of(s->dst, n) != static_cast<uint32_t>(crcw)) {
                uint64_t src = static_cast<uint32_t>(k.c);
                s->nbytes = src;
                mb->publish(rid, src, kCorrupt);
                return kKindDirect;
            }
            mb->publish(rid, n, len > s->cap ? kTruncated : kOk);
            return kKindDirect;
        }
    }
    Slot* ss = nullptr;
    // slot-space exhaustion (1M live requests) degrades rndv to an eager
    // copy rather than failing — correctness over the rndv optimization
    uint64_t sid = len <= eager_limit ? 0 : mb->alloc(&ss);
    if (sid == 0) {
        Unexp u;
        u.len = len;
        u.crc = crcw;
        if (len)
            u.owned.assign(static_cast<const uint8_t*>(data),
                           static_cast<const uint8_t*>(data) + len);
        sh.unexpected[k].push_back(std::move(u));
        return kKindEager;
    }
    ss->shard = shard_idx;
    Unexp u;
    u.ptr = data;
    u.len = len;
    u.sreq = sid;
    u.src_plan = src_plan;
    u.crc = crcw;
    sh.unexpected[k].push_back(std::move(u));
    return (sid << 3) | kKindRndv;
}

// shared core of ucc_mailbox_post_recv and the plan executor's recv
// pass: *plan_tag* marks the slot so a delivering push can nudge the
// owning plan; *nudge is set to a parked rndv SENDER's plan when this
// post lands its message (the send completes here).
uint64_t post_recv_impl(Mailbox* mb, const Key& k, void* dst, uint64_t cap,
                        void* plan_tag, void** nudge) {
    *nudge = nullptr;
    Slot* s = nullptr;
    uint64_t rid = mb->alloc(&s);
    if (rid == 0) return 0;
    uint32_t shard_idx;
    Shard& sh = mb->shard_for(k, &shard_idx);
    s->dst = dst;
    s->cap = cap;
    s->shard = shard_idx;
    s->plan = plan_tag;
    std::lock_guard<std::mutex> g(sh.mu);
    if (!sh.fences.empty() && mb->is_fenced(sh, k)) {
        mb->publish(rid, 0, kFenced);
        return rid;
    }
    auto it = sh.unexpected.find(k);
    if (it != sh.unexpected.end() && !it->second.empty()) {
        Unexp u = std::move(it->second.front());
        it->second.pop_front();
        if (it->second.empty()) sh.unexpected.erase(it);
        uint64_t n = u.len < cap ? u.len : cap;
        if (n)
            std::memcpy(dst, u.ptr != nullptr ? u.ptr : u.owned.data(), n);
        s->nbytes = n;
        s->sent = u.len;
        if ((u.crc >> 32) && u.len <= cap &&
            crc32_of(dst, n) != static_cast<uint32_t>(u.crc)) {
            uint64_t src = static_cast<uint32_t>(k.c);
            s->nbytes = src;
            mb->publish(rid, src, kCorrupt);
        } else {
            mb->publish(rid, n, u.len > cap ? kTruncated : kOk);
        }
        // send requests are freed AT DELIVERY: the bumped generation
        // reads as complete on the sender's side, and the C-side Request
        // no longer outlives its message (the v1 leak)
        if (u.sreq) {
            mb->free_rid(u.sreq);
            *nudge = u.src_plan;
        }
        return rid;
    }
    sh.posted[k].push_back(rid);
    return rid;
}

uint8_t* plan_base(Plan* p, uint32_t region) {
    return region ? p->scratch_base : p->user_base;
}

void plan_publish(Plan* p, uint64_t payload, uint32_t state) {
    p->mb->publish(p->state_rid, payload, state);
}

// elementwise accumulate matching numpy's out= ufuncs bit-for-bit on
// non-NaN data (NaN propagation follows np.maximum/np.minimum: a NaN on
// either side wins). Plain loops: -O3 autovectorizes them.
template <typename T>
void reduce_span(T* acc, const T* src, uint64_t n, uint32_t rop) {
    switch (rop) {
    case 0:
        for (uint64_t i = 0; i < n; ++i) acc[i] += src[i];
        break;
    case 1:
        for (uint64_t i = 0; i < n; ++i) acc[i] *= src[i];
        break;
    case 2:
        for (uint64_t i = 0; i < n; ++i) {
            T a = acc[i], b = src[i];
            acc[i] = (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
        }
        break;
    default:
        for (uint64_t i = 0; i < n; ++i) {
            T a = acc[i], b = src[i];
            acc[i] = (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
        }
        break;
    }
}

void plan_run_locals(Plan* p, const PlanRound& r) {
    for (const PlanLocalOp& op : r.locals) {
        uint8_t* dst = plan_base(p, op.region_dst) + op.off_dst;
        const uint8_t* src = plan_base(p, op.region_src) + op.off_src;
        if (op.kind == kOpCopy) {
            std::memcpy(dst, src, op.nbytes);
        } else if (op.dtype == 1) {
            reduce_span(reinterpret_cast<float*>(dst),
                        reinterpret_cast<const float*>(src),
                        op.nbytes / 4, op.rop);
        } else {
            reduce_span(reinterpret_cast<double*>(dst),
                        reinterpret_cast<const double*>(src),
                        op.nbytes / 8, op.rop);
        }
    }
}

// caller holds p->mu
void plan_finish_round(Plan* p) {
    ++p->ctr[4];
    ++p->round;
    if (p->round >= p->rounds.size()) {
        p->stage = kPlanDone;
        plan_publish(p, p->ctr[4], kOk);
    } else {
        p->stage = kPlanPostRecvs;
    }
}

void plan_advance(Plan* p) {
    std::lock_guard<std::mutex> g(p->mu);
    if (!p->live || p->canceled) return;
    for (;;) {
        switch (p->stage) {
        case kPlanPostRecvs: {
            const PlanRound& r = p->rounds[p->round];
            for (const PlanWireOp& w : r.recvs) {
                Key k{w.key_a, p->tag, w.key_c};
                void* nudge = nullptr;
                uint64_t rid = post_recv_impl(
                    p->mb, k, plan_base(p, w.region) + w.off, w.nbytes,
                    p, &nudge);
                plan_enqueue(nudge);
                if (rid == 0) {   // slot exhaustion: fail the plan
                    p->stage = kPlanDone;
                    plan_publish(p, p->round, kTruncated);
                    return;
                }
                p->pending.push_back({p->mb, rid, true});
            }
            if (r.pre_assist) {
                p->stage = kPlanPreAssist;
                plan_publish(p, (uint64_t(p->round) << 1) | 0, kAssist);
                return;
            }
            p->stage = kPlanPostSends;
            break;
        }
        case kPlanPostSends: {
            const PlanRound& r = p->rounds[p->round];
            for (const PlanWireOp& w : r.sends) {
                Key k{w.key_a, p->tag, w.key_c};
                void* nudge = nullptr;
                Mailbox* peer = p->peers[w.peer];
                uint64_t ret = push_impl(
                    peer, k, plan_base(p, w.region) + w.off, w.nbytes,
                    p->eager_limit, 0, p, &nudge);
                plan_enqueue(nudge);
                uint32_t kind = ret & 7u;
                ++p->ctr[kind & 3u];
                if (kind == kKindRndv)
                    p->pending.push_back({peer, ret >> 3, false});
            }
            p->stage = kPlanWait;
            break;
        }
        case kPlanWait: {
            uint32_t err = 0;
            bool all = true;
            for (const PendingReq& q : p->pending) {
                uint32_t idx = static_cast<uint32_t>(q.rid & kIdxMask);
                uint64_t v = q.mb->pub[idx].load(std::memory_order_acquire);
                if ((v >> 32) != (q.rid >> kSlotBits)) {
                    // freed under us: normal completion for a rndv send
                    // (freed at delivery or by a fence); for an owned
                    // recv it means an endpoint purge ripped the slot
                    // away — fail the plan, never touch the buffers
                    if (q.recv && err == 0) err = kTruncated;
                    continue;
                }
                uint32_t st = static_cast<uint32_t>(v & 7u);
                if (st == kPending) {
                    all = false;
                    break;
                }
                if (st == kCorrupt) {
                    // harvest the sender attribution the delivery parked
                    // in the nbytes field before the rid is freed below
                    ++p->ctr[6];
                    if (p->ctr[7] == 0)
                        p->ctr[7] = ((v >> 3) & kNbMax) + 1;
                }
                if (st != kOk && err == 0) err = st;
            }
            if (!all) return;   // a completing delivery re-nudges us
            for (const PendingReq& q : p->pending)
                if (q.recv) q.mb->free_rid(q.rid);
            p->pending.clear();
            if (err) {
                p->stage = kPlanDone;
                plan_publish(p, p->round, err);
                return;
            }
            const PlanRound& r = p->rounds[p->round];
            if (r.post_assist) {
                p->stage = kPlanPostAssist;
                plan_publish(p, (uint64_t(p->round) << 1) | 1, kAssist);
                return;
            }
            plan_run_locals(p, r);
            plan_finish_round(p);
            if (p->stage == kPlanDone) return;
            break;
        }
        default:
            return;   // idle / done / waiting on an assist callback
        }
    }
}

// caller holds p->mu: withdraw the current round's posted recvs (native
// cancel-skip + immediate free — the plan owns them) and stop waiting on
// rndv sends (they cannot be unsent, matching the python contract).
uint64_t plan_cancel_locked(Plan* p) {
    uint64_t withdrawn = 0;
    for (const PendingReq& q : p->pending) {
        if (!q.recv) continue;
        uint32_t idx = static_cast<uint32_t>(q.rid & kIdxMask);
        uint32_t gen = static_cast<uint32_t>(q.rid >> kSlotBits);
        Slot* s = q.mb->slot_of(idx);
        if (s == nullptr || s->gen.load(std::memory_order_acquire) != gen)
            continue;
        uint32_t shard = s->shard;
        std::lock_guard<std::mutex> g2(q.mb->shards[shard].mu);
        uint64_t v = q.mb->pub[idx].load(std::memory_order_acquire);
        if ((v >> 32) != gen || (v & 7u) != 0) continue;
        q.mb->publish(q.rid, 0, kCanceled);
        q.mb->free_rid(q.rid);
        ++withdrawn;
    }
    p->pending.clear();
    p->ctr[5] += withdrawn;
    return withdrawn;
}

}  // namespace

extern "C" {

uint64_t ucc_abi_version() { return kAbiVersion; }

uint64_t ucc_mailbox_purge(void* mbp);

void* ucc_mailbox_create() {
    Mailbox* mb = nullptr;
    {
        std::lock_guard<std::mutex> g(g_park_mu);
        if (!g_parked.empty()) {
            mb = g_parked.back();
            g_parked.pop_back();
        }
    }
    if (mb != nullptr) {
        // purge AGAIN at pop: a push that raced the destroy may have
        // parked a message in the already-purged parked mailbox; drop
        // it before the new owner can post a recv. Generations carry
        // over, so old-life rids keep reading as mismatched/complete.
        ucc_mailbox_purge(mb);
        // integrity arming does NOT carry over from the previous life
        mb->integrity.store(0, std::memory_order_relaxed);
        return mb;
    }
    return new Mailbox();
}

void ucc_mailbox_destroy(void* mbp) {
    auto* mb = static_cast<Mailbox*>(mbp);
    ucc_mailbox_purge(mb);   // drop parked state, bump every live gen
    std::lock_guard<std::mutex> g(g_park_mu);
    g_parked.push_back(mb);
}

// Base of the completion-publication array (kMaxSlots u64 words); stays
// readable after ucc_mailbox_destroy (the mailbox is parked, not freed),
// so a racing poller sees bumped generations, never unmapped memory.
void* ucc_mailbox_pub_base(void* mbp) {
    return static_cast<void*>(static_cast<Mailbox*>(mbp)->pub);
}

// Push a message. Returns (send_rid << 3) | kind:
//   direct — delivered copy-free into an already-posted recv (complete);
//   eager  — unexpected, <= eager_limit: staged copy, send complete;
//   rndv   — unexpected, parked zero-copy: the caller must keep *data*
//            alive until the returned send request completes;
//   fenced — stale team epoch: discarded, send complete.
// Only rndv carries a nonzero request id.
uint64_t ucc_mailbox_push(void* mbp, uint64_t a, uint64_t b, uint64_t c,
                          const void* data, uint64_t len,
                          uint64_t eager_limit) {
    void* nudge = nullptr;
    uint64_t ret = push_impl(static_cast<Mailbox*>(mbp), Key{a, b, c},
                             data, len, eager_limit, 0, nullptr, &nudge);
    // a delivery into a plan-posted recv advances that plan HERE, on the
    // delivering thread (no locks held: plan_ready drains a worklist)
    plan_ready(nudge);
    return ret;
}

// ABI 5: push with an explicit checksum word ((1<<32)|crc32 of *data* as
// the SENDER computed it, 0 = none). The fault injector uses this to
// hand the matcher a clean pre-corruption checksum — exactly what a
// wire-corrupted message looks like. Semantics otherwise identical to
// ucc_mailbox_push; delivery verifies and publishes kCorrupt on
// mismatch, naming the sender from the key's src word.
uint64_t ucc_mailbox_push2(void* mbp, uint64_t a, uint64_t b, uint64_t c,
                           const void* data, uint64_t len,
                           uint64_t eager_limit, uint64_t crcw) {
    void* nudge = nullptr;
    uint64_t ret = push_impl(static_cast<Mailbox*>(mbp), Key{a, b, c},
                             data, len, eager_limit, crcw, nullptr,
                             &nudge);
    plan_ready(nudge);
    return ret;
}

// ABI 5: arm (on != 0) or disarm wire integrity for this endpoint:
// armed mailboxes checksum every push lacking a caller word and verify
// every delivery — including plan-executor rounds, which never cross
// back into python.
void ucc_mailbox_set_integrity(void* mbp, uint64_t on) {
    static_cast<Mailbox*>(mbp)->integrity.store(
        on ? 1u : 0u, std::memory_order_relaxed);
}

// Post a receive into dst (capacity cap bytes). Returns the request id
// (0 on slot exhaustion). A post into a fenced epoch completes
// immediately with the fenced state (local stale-team bug, surfaced).
uint64_t ucc_mailbox_post_recv(void* mbp, uint64_t a, uint64_t b,
                               uint64_t c, void* dst, uint64_t cap) {
    void* nudge = nullptr;
    uint64_t rid = post_recv_impl(static_cast<Mailbox*>(mbp), Key{a, b, c},
                                  dst, cap, nullptr, &nudge);
    // landing a parked rndv send completes the SENDING plan's request:
    // advance it from here (its own thread only polls its state word)
    plan_ready(nudge);
    return rid;
}

// Fence every epoch of *team_id* below *min_epoch*: record the per-shard
// floor for future arrivals and purge already-parked state — posted
// recvs complete as fenced (their buffers may be reclaimed), unexpected
// sends are dropped and their rndv send requests freed (the sender must
// stop waiting; the data is gone with the old epoch). Returns the number
// of purged entries.
uint64_t ucc_mailbox_fence(void* mbp, uint64_t team_id, uint64_t min_epoch) {
    auto* mb = static_cast<Mailbox*>(mbp);
    uint32_t team = static_cast<uint32_t>(team_id);
    uint32_t epoch = static_cast<uint32_t>(min_epoch);
    uint64_t purged = 0;
    // plans whose requests this fence retires: nudged AFTER the shard
    // locks drop so they observe their fenced/freed state and error out
    // instead of waiting forever (cold path — fences are shrink-time)
    std::vector<void*> nudges;
    for (int i = 0; i < kShards; ++i) {
        Shard& sh = mb->shards[i];
        std::lock_guard<std::mutex> g(sh.mu);
        uint32_t& floor = sh.fences[team];
        if (epoch > floor) floor = epoch;
        for (auto it = sh.posted.begin(); it != sh.posted.end();) {
            const Key& k = it->first;
            if (static_cast<uint32_t>(k.a >> 32) == team &&
                static_cast<uint32_t>(k.a) < epoch) {
                for (uint64_t rid : it->second) {
                    Slot* s = mb->live_pending(rid);
                    if (s != nullptr) {
                        if (s->plan) nudges.push_back(s->plan);
                        mb->publish(rid, 0, kFenced);
                    }
                    ++purged;
                }
                it = sh.posted.erase(it);
            } else {
                ++it;
            }
        }
        for (auto it = sh.unexpected.begin(); it != sh.unexpected.end();) {
            const Key& k = it->first;
            if (static_cast<uint32_t>(k.a >> 32) == team &&
                static_cast<uint32_t>(k.a) < epoch) {
                for (Unexp& u : it->second) {
                    if (u.sreq) {
                        mb->free_rid(u.sreq);
                        if (u.src_plan) nudges.push_back(u.src_plan);
                    }
                    ++purged;
                }
                it = sh.unexpected.erase(it);
            } else {
                ++it;
            }
        }
    }
    for (void* n : nudges) plan_ready(n);
    return purged;
}

// Endpoint-teardown reclamation: drop all parked state and free every
// live request slot (abandoned requests otherwise leak until destroy).
// Callers must be past the point of posting on this mailbox; outstanding
// Python-side requests read the bumped generations as complete.
uint64_t ucc_mailbox_purge(void* mbp) {
    auto* mb = static_cast<Mailbox*>(mbp);
    uint64_t n = 0;
    for (int i = 0; i < kShards; ++i) {
        Shard& sh = mb->shards[i];
        std::lock_guard<std::mutex> g(sh.mu);
        for (auto& kv : sh.unexpected)
            for (Unexp& u : kv.second) {
                if (u.sreq) mb->free_rid(u.sreq);
                ++n;
            }
        sh.unexpected.clear();
        // posted recvs are NOT counted here: each holds a live request
        // slot that the sweep below frees (and counts) exactly once
        sh.posted.clear();
        sh.fences.clear();
    }
    std::lock_guard<std::mutex> g(mb->alloc_mu);
    for (uint32_t idx = 0; idx < mb->next_slot; ++idx) {
        Slot* s = mb->slot_of(idx);
        if (s == nullptr) continue;
        uint32_t gen = s->gen.load(std::memory_order_relaxed);
        if (gen & 1u) {
            s->gen.store(gen + 1, std::memory_order_relaxed);
            mb->pub[idx].store(static_cast<uint64_t>(gen + 1) << 32,
                               std::memory_order_release);
            mb->free_list.push_back(idx);
            ++n;
        }
    }
    return n;
}

// Backlog snapshot for the observability layer (cold diagnostic path):
// out[0] = parked unexpected messages, out[1] = parked posted recvs,
// out[2] = live request slots (allocated minus freed — the slot-table
// in-use count the watchdog/interval dumps sample as a gauge).
void ucc_mailbox_occupancy(void* mbp, uint64_t* out) {
    auto* mb = static_cast<Mailbox*>(mbp);
    uint64_t unexp = 0, posted = 0;
    for (int i = 0; i < kShards; ++i) {
        Shard& sh = mb->shards[i];
        std::lock_guard<std::mutex> g(sh.mu);
        for (auto& kv : sh.unexpected) unexp += kv.second.size();
        for (auto& kv : sh.posted) posted += kv.second.size();
    }
    uint64_t live;
    {
        std::lock_guard<std::mutex> g(mb->alloc_mu);
        live = mb->next_slot - mb->free_list.size();
    }
    out[0] = unexp;
    out[1] = posted;
    out[2] = live;
}

// Poll one request: 0 = pending, else (nbytes<<3)|state — the same word
// the mapped pub array yields, for callers without the mapping.
uint64_t ucc_req_poll(void* mbp, uint64_t rid) {
    return poll_rid(static_cast<Mailbox*>(mbp), rid);
}

// Batch-poll: fills out[i] with the poll word for rids[i]; returns how
// many are complete. One ffi call for a whole progress-loop pass.
uint64_t ucc_req_test_many(void* mbp, uint64_t n, const uint64_t* rids,
                           uint64_t* out) {
    auto* mb = static_cast<Mailbox*>(mbp);
    uint64_t done = 0;
    for (uint64_t i = 0; i < n; ++i) {
        out[i] = poll_rid(mb, rids[i]);
        if (out[i] != 0) ++done;
    }
    return done;
}

uint64_t ucc_req_nbytes(void* mbp, uint64_t rid) {
    auto* mb = static_cast<Mailbox*>(mbp);
    uint32_t idx = static_cast<uint32_t>(rid & kIdxMask);
    Slot* s = mb->slot_of(idx);
    if (s == nullptr ||
        s->gen.load(std::memory_order_acquire) !=
            static_cast<uint32_t>(rid >> kSlotBits))
        return 0;
    return s->nbytes;
}

// Total bytes of the send matched to this recv (truncation error text).
uint64_t ucc_req_sent_nbytes(void* mbp, uint64_t rid) {
    auto* mb = static_cast<Mailbox*>(mbp);
    uint32_t idx = static_cast<uint32_t>(rid & kIdxMask);
    Slot* s = mb->slot_of(idx);
    if (s == nullptr ||
        s->gen.load(std::memory_order_acquire) !=
            static_cast<uint32_t>(rid >> kSlotBits))
        return 0;
    return s->sent;
}

// Withdraw a posted recv: the mailbox skips cancelled entries at match
// time. Taken under the owning shard's lock — delivery happens inside
// that lock too, so cancel-vs-match cannot interleave: whichever wins
// the lock decides, and a request that was already delivered stays
// delivered. Returns 1 when cancelled here, 0 when already complete.
int ucc_req_cancel(void* mbp, uint64_t rid) {
    auto* mb = static_cast<Mailbox*>(mbp);
    uint32_t idx = static_cast<uint32_t>(rid & kIdxMask);
    uint32_t gen = static_cast<uint32_t>(rid >> kSlotBits);
    Slot* s = mb->slot_of(idx);
    if (s == nullptr || s->gen.load(std::memory_order_acquire) != gen)
        return 0;
    uint32_t shard = s->shard;
    // if the slot was freed+reused between the reads above and the lock,
    // we may hold the wrong shard's lock — the generation recheck below
    // rejects that case before any state transition
    std::lock_guard<std::mutex> g(mb->shards[shard].mu);
    uint64_t v = mb->pub[idx].load(std::memory_order_acquire);
    if ((v >> 32) != gen || (v & 7u) != 0) return 0;
    mb->publish(rid, 0, kCanceled);
    return 1;
}

void ucc_req_free(void* mbp, uint64_t rid) {
    static_cast<Mailbox*>(mbp)->free_rid(rid);
}

void ucc_req_free_many(void* mbp, uint64_t n, const uint64_t* rids) {
    auto* mb = static_cast<Mailbox*>(mbp);
    for (uint64_t i = 0; i < n; ++i) mb->free_rid(rids[i]);
}

// ---------------------------------------------------------------------------
// execution-plan API (ABI 4). See the Plan section above for semantics.
// ---------------------------------------------------------------------------

// Build a plan from the packed op table (n_ops entries of kPlanOpWords
// u64 words each; rounds are delimited by WAIT_ROUND entries whose flags
// carry the assist bits). Returns the plan handle, or nullptr on a
// malformed table / slot exhaustion. out[0] = the plan's state-word
// request id in *my_mb*'s mapped pub window (poll = one memory load),
// out[1] = the address of the plan's counter array (mapped read-only;
// valid forever — plans are parked at destroy, never freed).
void* ucc_plan_build(void* my_mb, uint64_t n_peers, void* const* peer_mbs,
                     uint64_t n_ops, const uint64_t* ops,
                     void* scratch_base, uint64_t eager_limit,
                     uint64_t* out) {
    auto* mb = static_cast<Mailbox*>(my_mb);
    if (mb == nullptr || n_ops == 0) return nullptr;
    Plan* p = nullptr;
    {
        std::lock_guard<std::mutex> g(g_plan_park_mu);
        if (!g_plan_parked.empty()) {
            p = g_plan_parked.back();
            g_plan_parked.pop_back();
        }
    }
    if (p == nullptr) p = new Plan();
    p->rounds.clear();
    p->peers.assign(reinterpret_cast<Mailbox* const*>(peer_mbs),
                    reinterpret_cast<Mailbox* const*>(peer_mbs) + n_peers);
    p->pending.clear();
    p->mb = mb;
    p->eager_limit = eager_limit;
    p->scratch_base = static_cast<uint8_t*>(scratch_base);
    p->user_base = nullptr;
    p->tag = 0;
    p->round = 0;
    p->stage = kPlanIdle;
    p->canceled = false;
    p->parked = false;
    for (uint64_t& c : p->ctr) c = 0;

    bool ok = true;
    PlanRound cur;
    bool closed = true;   // table must end on a WAIT_ROUND
    for (uint64_t i = 0; ok && i < n_ops; ++i) {
        const uint64_t* w = ops + i * kPlanOpWords;
        uint32_t kind = static_cast<uint32_t>(w[0] & 0xFF);
        uint32_t flags = static_cast<uint32_t>((w[0] >> 8) & 0xFF);
        closed = false;
        switch (kind) {
        case kOpPostSend: {
            PlanWireOp op;
            op.key_a = w[1];
            op.key_c = w[2];
            op.peer = static_cast<uint32_t>(w[3]);
            op.region = static_cast<uint32_t>(w[4] & 0xF);
            op.off = w[5];
            op.nbytes = w[7];
            if (op.peer >= p->peers.size() ||
                p->peers[op.peer] == nullptr || op.region > 1) {
                ok = false;
                break;
            }
            cur.sends.push_back(op);
            break;
        }
        case kOpPostRecv: {
            PlanWireOp op;
            op.key_a = w[1];
            op.key_c = w[2];
            op.region = static_cast<uint32_t>(w[4] & 0xF);
            op.off = w[5];
            op.nbytes = w[7];
            if (op.region > 1) {
                ok = false;
                break;
            }
            cur.recvs.push_back(op);
            break;
        }
        case kOpReduce:
        case kOpCopy: {
            PlanLocalOp op;
            op.kind = kind;
            op.region_dst = static_cast<uint32_t>(w[4] & 0xF);
            op.region_src = static_cast<uint32_t>((w[4] >> 4) & 0xF);
            op.dtype = static_cast<uint32_t>((w[4] >> 8) & 0xFF);
            op.rop = static_cast<uint32_t>((w[4] >> 16) & 0xFF);
            op.off_dst = w[5];
            op.off_src = w[6];
            op.nbytes = w[7];
            if (op.region_dst > 1 || op.region_src > 1 ||
                (kind == kOpReduce && op.rop > 3)) {
                ok = false;
                break;
            }
            cur.locals.push_back(op);
            break;
        }
        case kOpEncode:
        case kOpDecode:
            // python-assist ops: C never executes these, but records
            // them so the closing WAIT_ROUND is validated to carry the
            // matching assist flag
            cur.locals.push_back(PlanLocalOp{kind, 0, 0, 0, 0, 0, 0, 0});
            break;
        case kOpWaitRound: {
            cur.pre_assist = (flags & kPlanFlagPreAssist) != 0;
            cur.post_assist = (flags & kPlanFlagPostAssist) != 0;
            // validate: every local op C cannot execute needs an assist
            // flag routing the round to python (a silent skip would
            // complete the collective with wrong data)
            std::vector<PlanLocalOp> native_locals;
            for (const PlanLocalOp& op : cur.locals) {
                if (op.kind == kOpEncode) {
                    if (!cur.pre_assist) ok = false;
                } else if (op.kind == kOpDecode) {
                    if (!cur.post_assist) ok = false;
                } else if (op.kind == kOpReduce &&
                           op.dtype != 1 && op.dtype != 2) {
                    if (!cur.post_assist) ok = false;
                } else {
                    native_locals.push_back(op);
                }
            }
            cur.locals = std::move(native_locals);
            p->rounds.push_back(std::move(cur));
            cur = PlanRound();
            closed = true;
            break;
        }
        default:
            ok = false;
            break;
        }
    }
    if (!ok || !closed || p->rounds.empty()) {
        std::lock_guard<std::mutex> g(g_plan_park_mu);
        p->parked = true;
        g_plan_parked.push_back(p);
        return nullptr;
    }
    Slot* s = nullptr;
    p->state_rid = mb->alloc(&s);
    if (p->state_rid == 0) {
        std::lock_guard<std::mutex> g(g_plan_park_mu);
        p->parked = true;
        g_plan_parked.push_back(p);
        return nullptr;
    }
    p->live = true;
    out[0] = p->state_rid;
    out[1] = static_cast<uint64_t>(reinterpret_cast<uintptr_t>(p->ctr));
    return p;
}

// Post the plan: ONE ffi crossing runs the whole collective — rounds
// past the first advance delivery-driven on whichever thread completes
// them. *user_base* rebases region-0 offsets (the caller's dst vector),
// *tag* is baked into every key as word b. Returns 0, -1 (dead plan),
// -2 (still running — the caller must not share one plan across
// concurrent collectives).
int ucc_plan_post(void* pv, void* user_base, uint64_t tag) {
    g_plan_ffi.fetch_add(1, std::memory_order_relaxed);
    Plan* p = static_cast<Plan*>(pv);
    {
        std::lock_guard<std::mutex> g(p->mu);
        if (!p->live) return -1;
        if (p->stage != kPlanIdle && p->stage != kPlanDone) return -2;
        p->user_base = static_cast<uint8_t*>(user_base);
        p->tag = tag;
        p->round = 0;
        p->canceled = false;
        p->pending.clear();
        p->ctr[0] = p->ctr[1] = p->ctr[2] = p->ctr[3] = p->ctr[4] = 0;
        p->stage = kPlanPostRecvs;
        plan_publish(p, 0, kPending);
    }
    plan_ready(p);
    return 0;
}

// Fallback nudge (stall recovery / teardown paths): re-checks the
// current round's completions and returns the state bits of the plan
// word. Not needed on the happy path — deliveries advance the plan.
uint64_t ucc_plan_test(void* pv) {
    g_plan_ffi.fetch_add(1, std::memory_order_relaxed);
    Plan* p = static_cast<Plan*>(pv);
    plan_ready(p);
    std::lock_guard<std::mutex> g(p->mu);
    if (!p->live) return kCanceled;
    return poll_rid(p->mb, p->state_rid);
}

// Python ran the flagged assist phase (encode before sends / the
// round's local ops after completion): resume C-side advancement.
void ucc_plan_assist_done(void* pv) {
    g_plan_ffi.fetch_add(1, std::memory_order_relaxed);
    Plan* p = static_cast<Plan*>(pv);
    {
        std::lock_guard<std::mutex> g(p->mu);
        if (!p->live || p->canceled) return;
        if (p->stage == kPlanPreAssist) {
            plan_publish(p, 0, kPending);
            p->stage = kPlanPostSends;
        } else if (p->stage == kPlanPostAssist) {
            plan_publish(p, 0, kPending);
            plan_finish_round(p);
        } else {
            return;
        }
    }
    plan_ready(p);
}

// Abort a posted plan: withdraw the current round's posted recvs (the
// native cancel-skip — a late peer send can no longer scribble into
// plan buffers), stop waiting on parked rndv sends, and publish the
// canceled state. Returns the number of recvs withdrawn.
uint64_t ucc_plan_cancel(void* pv) {
    Plan* p = static_cast<Plan*>(pv);
    std::lock_guard<std::mutex> g(p->mu);
    if (!p->live) return 0;
    p->canceled = true;
    uint64_t withdrawn = plan_cancel_locked(p);
    if (p->stage != kPlanDone && p->stage != kPlanIdle)
        plan_publish(p, p->round, kCanceled);
    p->stage = kPlanDone;
    return withdrawn;
}

void ucc_plan_counters(void* pv, uint64_t* out) {
    Plan* p = static_cast<Plan*>(pv);
    std::lock_guard<std::mutex> g(p->mu);
    for (int i = 0; i < 8; ++i) out[i] = p->ctr[i];
}

// Retire a plan: cancel whatever is still posted, free the state slot,
// and PARK the plan object (like mailboxes — a delivery racing this
// call may still hold the raw pointer; a parked plan reads !live under
// its mutex and the nudge becomes a no-op, never a use-after-free).
void ucc_plan_destroy(void* pv) {
    Plan* p = static_cast<Plan*>(pv);
    {
        std::lock_guard<std::mutex> g(p->mu);
        if (p->parked) return;
        p->parked = true;
        if (p->live) {
            p->canceled = true;
            plan_cancel_locked(p);
            if (p->state_rid) p->mb->free_rid(p->state_rid);
        }
        p->live = false;
        p->state_rid = 0;
        p->rounds.clear();
        p->peers.clear();
        p->pending.clear();
    }
    std::lock_guard<std::mutex> g(g_plan_park_mu);
    g_plan_parked.push_back(p);
}

// data-path ffi crossings so far (post/test/assist_done): the CI plans
// smoke asserts the delta over one collective == 1 per rank.
uint64_t ucc_plan_ffi_calls() {
    return g_plan_ffi.load(std::memory_order_relaxed);
}

// ---------------------------------------------------------------------------
// bounded MPMC queue (ucc_lock_free_queue.h analog): CAS ring of uint64.
// ---------------------------------------------------------------------------

struct MpmcCell {
    std::atomic<uint64_t> seq;
    uint64_t value;
};

struct MpmcQueue {
    std::unique_ptr<MpmcCell[]> cells;   // atomics are not movable: raw array
    size_t mask;
    std::atomic<uint64_t> head{0};
    std::atomic<uint64_t> tail{0};

    explicit MpmcQueue(size_t capacity) {
        size_t cap = 1;
        while (cap < capacity) cap <<= 1;
        cells = std::make_unique<MpmcCell[]>(cap);
        mask = cap - 1;
        for (size_t i = 0; i < cap; ++i)
            cells[i].seq.store(i, std::memory_order_relaxed);
    }
};

void* ucc_mpmc_create(uint64_t capacity) { return new MpmcQueue(capacity); }
void ucc_mpmc_destroy(void* q) { delete static_cast<MpmcQueue*>(q); }

int ucc_mpmc_push(void* qp, uint64_t v) {
    auto* q = static_cast<MpmcQueue*>(qp);
    uint64_t pos = q->tail.load(std::memory_order_relaxed);
    for (;;) {
        MpmcCell& c = q->cells[pos & q->mask];
        uint64_t seq = c.seq.load(std::memory_order_acquire);
        intptr_t dif = (intptr_t)seq - (intptr_t)pos;
        if (dif == 0) {
            if (q->tail.compare_exchange_weak(pos, pos + 1,
                                              std::memory_order_relaxed)) {
                c.value = v;
                c.seq.store(pos + 1, std::memory_order_release);
                return 1;
            }
        } else if (dif < 0) {
            return 0;  // full
        } else {
            pos = q->tail.load(std::memory_order_relaxed);
        }
    }
}

int ucc_mpmc_pop(void* qp, uint64_t* out) {
    auto* q = static_cast<MpmcQueue*>(qp);
    uint64_t pos = q->head.load(std::memory_order_relaxed);
    for (;;) {
        MpmcCell& c = q->cells[pos & q->mask];
        uint64_t seq = c.seq.load(std::memory_order_acquire);
        intptr_t dif = (intptr_t)seq - (intptr_t)(pos + 1);
        if (dif == 0) {
            if (q->head.compare_exchange_weak(pos, pos + 1,
                                              std::memory_order_relaxed)) {
                *out = c.value;
                c.seq.store(pos + q->mask + 1, std::memory_order_release);
                return 1;
            }
        } else if (dif < 0) {
            return 0;  // empty
        } else {
            pos = q->head.load(std::memory_order_relaxed);
        }
    }
}

}  // extern "C"

#else  // UCC_TPU_EXT_THIN

// thin wrapper build: the matcher lives ONLY in libucc_tpu_core.so
// (DT_NEEDED + $ORIGIN rpath resolve to the same loaded object ctypes
// opened) — declare the two hot-path entry points this module forwards to
extern "C" {
uint64_t ucc_mailbox_push(void* mbp, uint64_t a, uint64_t b, uint64_t c,
                          const void* data, uint64_t len,
                          uint64_t eager_limit);
uint64_t ucc_mailbox_post_recv(void* mbp, uint64_t a, uint64_t b,
                               uint64_t c, void* dst, uint64_t cap);
}

#endif  // UCC_TPU_EXT_THIN

// ---------------------------------------------------------------------------
// optional CPython extension wrappers (built as ucc_tpu_core_ext.so when a
// Python.h is available): METH_FASTCALL entry points for the per-message
// hot calls, taking the buffer straight from the ndarray's buffer protocol
// (no ctypes marshalling, no .ctypes.data property construction) and
// releasing the GIL around the matcher work.
// ---------------------------------------------------------------------------

#ifdef UCC_TPU_PY_EXT

namespace {

int u64_args(PyObject* const* args, uint64_t* out, int n) {
    for (int i = 0; i < n; ++i) {
        out[i] = PyLong_AsUnsignedLongLong(args[i]);
        if (out[i] == (uint64_t)-1 && PyErr_Occurred()) return -1;
    }
    return 0;
}

// push(mb, a, b, c, buf, eager_limit) -> (send_rid << 3) | kind
PyObject* py_push(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
    if (nargs != 6) {
        PyErr_SetString(PyExc_TypeError, "push expects 6 arguments");
        return nullptr;
    }
    uint64_t w[4];
    if (u64_args(args, w, 4) != 0) return nullptr;
    uint64_t eager = PyLong_AsUnsignedLongLong(args[5]);
    if (eager == (uint64_t)-1 && PyErr_Occurred()) return nullptr;
    Py_buffer view;
    if (PyObject_GetBuffer(args[4], &view, PyBUF_C_CONTIGUOUS) != 0)
        return nullptr;
    uint64_t ret;
    Py_BEGIN_ALLOW_THREADS
    ret = ucc_mailbox_push(reinterpret_cast<void*>(
                               static_cast<uintptr_t>(w[0])),
                           w[1], w[2], w[3], view.buf,
                           static_cast<uint64_t>(view.len), eager);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&view);
    return PyLong_FromUnsignedLongLong(ret);
}

// post_recv(mb, a, b, c, buf) -> rid
PyObject* py_post_recv(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
    if (nargs != 5) {
        PyErr_SetString(PyExc_TypeError, "post_recv expects 5 arguments");
        return nullptr;
    }
    uint64_t w[4];
    if (u64_args(args, w, 4) != 0) return nullptr;
    Py_buffer view;
    if (PyObject_GetBuffer(args[4], &view,
                           PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) != 0)
        return nullptr;
    uint64_t rid;
    Py_BEGIN_ALLOW_THREADS
    rid = ucc_mailbox_post_recv(reinterpret_cast<void*>(
                                    static_cast<uintptr_t>(w[0])),
                                w[1], w[2], w[3], view.buf,
                                static_cast<uint64_t>(view.len));
    Py_END_ALLOW_THREADS
    // the C side holds a raw pointer until delivery/cancel/purge; the
    // PYTHON side pins the ndarray (dst_keepalive), matching the ctypes
    // path, so releasing the view here is safe
    PyBuffer_Release(&view);
    return PyLong_FromUnsignedLongLong(rid);
}

PyObject* py_abi_version(PyObject*, PyObject*) {
    // the ext's OWN compiled-in version, not a forward to the core: the
    // loader's gate must reject a wrapper built against a different ABI
    return PyLong_FromUnsignedLongLong(kAbiVersion);
}

PyMethodDef kExtMethods[] = {
    {"push", reinterpret_cast<PyCFunction>(
                 reinterpret_cast<void*>(py_push)),
     METH_FASTCALL, "push(mb, a, b, c, buf, eager_limit) -> packed kind"},
    {"post_recv", reinterpret_cast<PyCFunction>(
                      reinterpret_cast<void*>(py_post_recv)),
     METH_FASTCALL, "post_recv(mb, a, b, c, buf) -> request id"},
    {"abi_version", py_abi_version, METH_NOARGS,
     "native core ABI version"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kExtModule = {
    PyModuleDef_HEAD_INIT, "ucc_tpu_core_ext",
    "fastcall wrappers for the ucc_tpu native core hot path",
    -1, kExtMethods,
    nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_ucc_tpu_core_ext(void) {
    return PyModule_Create(&kExtModule);
}

#endif  // UCC_TPU_PY_EXT
