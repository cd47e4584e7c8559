// ucc_tpu_torch_ipc.cc — cross-process shared-memory arena (ABI 6): the
// port's own copy of the JAX package's arena, compiled with
// ucc_tpu_torch_core.cc into one library by ucc_tpu_torch/native.py.
//
// One mmap'd POSIX shm segment per node holds everything two processes
// need to run the mailbox contract against each other: the TagKey match
// structures (per-shard bucket chains of offset-linked entries under
// process-shared ROBUST mutexes), the completion-publication slot array
// (each process maps it once and polls a request with one aligned load,
// exactly like the in-process pub window), lock-free MPMC rings serving
// as the slot/entry/payload-block free lists (the Vyukov CAS ring from
// ucc_tpu_torch_core.cc, re-laid-out with plain u64 offsets so it is position-
// independent), a key intern table (team keys and tuple tags must map to
// the SAME u64 ids in every process — a per-process counter cannot), a
// per-rank pid + heartbeat board (cross-process liveness for UCC_FT and
// the leaked-segment reaper), and a window heap for the pooled tier's
// one-sided put+flag collectives.
//
// Everything in the segment is addressed by OFFSET from the mapping
// base, never by pointer: each process maps the segment wherever mmap
// puts it. The only non-shared state is the per-process attach handle.
//
// Delivery contracts mirror tl/host/transport.Mailbox and the in-process
// native matcher:
//   - posted-recv match: the SENDER memcpys straight into the receiver's
//     registered arena destination inside the push call (n_direct), and
//     the receiver's completion is published into its mapped pub slot;
//   - unexpected small sends stage into an arena payload block (eager,
//     sender completes immediately);
//   - unexpected large sends stage into an arena payload block but keep
//     RNDV semantics: the sender's request completes only when a recv
//     consumes the entry (raw pointers cannot cross address spaces, so
//     cross-process rndv is copy-staged; the completion contract — and
//     the n_rndv accounting — is preserved);
//   - epoch fences discard stale traffic at the match boundary and purge
//     parked state (kFenced);
//   - cancel-skip: a cancelled posted recv is unlinked under the same
//     shard lock that matches, so cancel-vs-match cannot interleave;
//   - integrity: a sender-computed crc32 word rides the entry and is
//     re-verified over the DELIVERED bytes (catches a torn copy either
//     side of the boundary), publishing kCorrupt with sender attribution.
//
// Crash story: shard/table mutexes are PTHREAD_MUTEX_ROBUST — a process
// SIGKILLed while holding one leaves EOWNERDEAD, the next locker calls
// pthread_mutex_consistent and continues (bucket chains stay walkable
// because inserts publish the head pointer last and unlinks are single
// pointer writes). State the dead process parked (entries keyed to its
// rank, its request slots) is bounded and reclaimed by
// ucc_ipc_purge_rank / the whole-segment reaper in ucc_tpu_torch/native.py.

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>

namespace {

constexpr uint64_t kArenaMagic = 0x414E455241434355ull;  // "UCCARENA"
constexpr uint64_t kArenaAbi = 6;

// request-id / pub-word layout: IDENTICAL to the in-process matcher so
// ucc_tpu_torch/native.py reuses its masks — rid = (gen & 0xffffffff) << 20 |
// slot index; pub = (gen << 32) | (min(nbytes, kNbMax) << 3) | state
constexpr uint64_t kSlotBits = 20;
constexpr uint64_t kIdxMask = (1ull << kSlotBits) - 1;
constexpr uint64_t kNbMax = (1ull << 29) - 1;

constexpr uint64_t kOk = 1;
constexpr uint64_t kTruncated = 2;
constexpr uint64_t kFenced = 3;
constexpr uint64_t kCanceled = 4;
constexpr uint64_t kCorrupt = 6;

// push return kinds (low 3 bits of the return word)
constexpr uint64_t kKindDirect = 0;
constexpr uint64_t kKindEager = 1;
constexpr uint64_t kKindRndv = 2;
constexpr uint64_t kKindFenced = 3;
// arena-only: the payload heap (or a table) is exhausted — the python
// side surfaces ERR_NO_RESOURCE naming the UCC_TL_IPC_HEAP knob instead
// of silently degrading
constexpr uint64_t kKindNoMem = 7;

constexpr uint64_t kShards = 16;
constexpr uint64_t kBuckets = 512;        // per shard
constexpr uint64_t kSlotCap = 1ull << 16;
constexpr uint64_t kEntryCap = 1ull << 15;
constexpr uint64_t kMaxRanks = 256;
constexpr uint64_t kFenceCap = 256;
constexpr uint64_t kInternCap = 4096;
constexpr uint64_t kInternBytes = 120;
// window table sized for tuner sweeps: a pooled allreduce resolves
// O(n^2 * chunks) windows PER (payload size, variant) cell and the
// sweep walks a dozen sizes, so 256 slots exhaust mid-sweep
constexpr uint64_t kWindowCap = 4096;
constexpr uint64_t kNumClasses = 4;
constexpr uint64_t kClassSizes[kNumClasses] = {
    4096, 65536, 1ull << 20, 8ull << 20};

// counter indices (ucc_arena_counters exports the whole block)
enum {
  C_DIRECT = 0, C_EAGER, C_RNDV, C_FENCED, C_BYTES, C_ATTACHES,
  C_ALLOC_FAIL, C_UNEXP, C_POSTED, C_SLOTS_LIVE, C_PURGED, C_CORRUPT,
  C_TRUNCATED, C_CANCELED, C_INTERN_N, C_WINDOW_N, C_WIN_BYTES,
  C_BLOCKS_LIVE, C_COUNT = 24
};

// ---------------------------------------------------------------------------
// crc32 (zlib-identical, reflected 0xEDB88320) — duplicated from the core
// TU (anonymous namespace, no symbol clash) so this file stays
// self-contained and the Makefile needs no link-order care.
// ---------------------------------------------------------------------------

struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};

uint32_t crc32_of(const void* data, uint64_t n) {
  static const Crc32Table tbl;
  const unsigned char* p = static_cast<const unsigned char*>(data);
  uint32_t c = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < n; ++i) c = tbl.t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// process-shared structures (all standard-layout; offsets, never pointers)
// ---------------------------------------------------------------------------

struct ShmRingCell {
  std::atomic<uint64_t> seq;
  uint64_t val;
};

// Vyukov bounded MPMC queue, process-shared: the free lists for request
// slots, match entries and payload blocks. Lock-free (CAS on the
// enqueue/dequeue cursors), so the data path never takes the allocation
// mutex the in-process matcher needs — and a SIGKILLed process can stall
// a ring for at most one incomplete cell handoff, never deadlock it.
struct ShmRing {
  std::atomic<uint64_t> enq;
  char pad0[56];
  std::atomic<uint64_t> deq;
  char pad1[56];
  uint64_t mask;
  char pad2[56];
  // cells follow inline
  ShmRingCell* cells() { return reinterpret_cast<ShmRingCell*>(this + 1); }

  void init(uint64_t capacity_pow2) {
    enq.store(0, std::memory_order_relaxed);
    deq.store(0, std::memory_order_relaxed);
    mask = capacity_pow2 - 1;
    for (uint64_t i = 0; i < capacity_pow2; ++i) {
      cells()[i].seq.store(i, std::memory_order_relaxed);
      cells()[i].val = 0;
    }
  }

  bool push(uint64_t v) {
    ShmRingCell* cell;
    uint64_t pos = enq.load(std::memory_order_relaxed);
    for (;;) {
      cell = &cells()[pos & mask];
      uint64_t seq = cell->seq.load(std::memory_order_acquire);
      intptr_t dif = static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos);
      if (dif == 0) {
        if (enq.compare_exchange_weak(pos, pos + 1,
                                      std::memory_order_relaxed))
          break;
      } else if (dif < 0) {
        return false;  // full
      } else {
        pos = enq.load(std::memory_order_relaxed);
      }
    }
    cell->val = v;
    cell->seq.store(pos + 1, std::memory_order_release);
    return true;
  }

  bool pop(uint64_t* out) {
    ShmRingCell* cell;
    uint64_t pos = deq.load(std::memory_order_relaxed);
    for (;;) {
      cell = &cells()[pos & mask];
      uint64_t seq = cell->seq.load(std::memory_order_acquire);
      intptr_t dif =
          static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos + 1);
      if (dif == 0) {
        if (deq.compare_exchange_weak(pos, pos + 1,
                                      std::memory_order_relaxed))
          break;
      } else if (dif < 0) {
        return false;  // empty
      } else {
        pos = deq.load(std::memory_order_relaxed);
      }
    }
    *out = cell->val;
    cell->seq.store(pos + mask + 1, std::memory_order_release);
    return true;
  }

  static uint64_t bytes_for(uint64_t capacity_pow2) {
    return sizeof(ShmRing) + capacity_pow2 * sizeof(ShmRingCell);
  }
};

// one match entry: a posted recv or a parked unexpected send. Chained
// off its bucket by offset; recycled through the entry free-list ring.
struct IpcEntry {
  uint64_t ka, kb, kc, kd;  // (team<<32|epoch, coll_tag, slot<<32|src, dst)
  uint64_t next;            // next entry offset in the bucket chain (0=end)
  uint64_t kind;            // 1 = posted recv, 2 = unexpected send
  uint64_t data_off;        // recv destination / staged payload (arena off)
  uint64_t nbytes;          // recv capacity / payload length
  uint64_t rid;             // receiver rid (posted) / sender rndv rid (unexp)
  uint64_t crc_word;        // (1<<32)|crc32 when integrity armed, else 0
  uint64_t flags;           // bit0: cancelled (skip at match)
  uint64_t pad;
};
static_assert(sizeof(IpcEntry) == 96, "entry layout");

struct Shard {
  pthread_mutex_t mu;
  char pad[128 - sizeof(pthread_mutex_t) % 128];
};

struct FenceSlot {
  std::atomic<uint64_t> team;
  std::atomic<uint64_t> min_epoch;
};

struct PidSlot {
  std::atomic<uint64_t> pid;
  std::atomic<uint64_t> beat_ns;  // CLOCK_MONOTONIC (same clock node-wide)
};

struct InternSlot {
  uint64_t len;  // 0 = free
  unsigned char bytes[kInternBytes];
};

struct WindowSlot {
  uint64_t key;     // interned id or caller hash; 0 = free
  uint64_t off;
  uint64_t nbytes;
};

struct ArenaHdr {
  uint64_t magic;
  uint64_t abi;
  uint64_t total_bytes;
  uint64_t creator_pid;
  std::atomic<uint64_t> ready;   // creator publishes 1 after full init
  uint64_t slot_cap;
  uint64_t entry_cap;
  uint64_t nshards;
  uint64_t nbuckets;
  uint64_t class_size[kNumClasses];
  uint64_t class_cnt[kNumClasses];
  uint64_t win_bytes;
  std::atomic<uint64_t> win_bump;
  std::atomic<uint64_t> fence_n;
  std::atomic<uint64_t> ctr[C_COUNT];
  // region offsets from base
  uint64_t off_shards, off_fence, off_pids, off_intern, off_windows;
  uint64_t off_buckets, off_pub, off_gen, off_nb, off_sent;
  uint64_t off_slot_ring, off_entry_ring, off_entries;
  uint64_t off_class_ring[kNumClasses];
  uint64_t off_blocks, off_winheap;
  pthread_mutex_t big_mu;  // intern / window / fence-append / pid tables
};

// per-process attach handle (heap, never shared)
struct Att {
  char* base;
  uint64_t len;
  uint64_t integrity;  // arm delivery-time crc verification
  int created;
  char name[128];
};

inline ArenaHdr* hdr(Att* a) { return reinterpret_cast<ArenaHdr*>(a->base); }
template <typename T>
inline T* at_off(Att* a, uint64_t off) {
  return reinterpret_cast<T*>(a->base + off);
}

inline uint64_t align_up(uint64_t v, uint64_t al) {
  return (v + al - 1) & ~(al - 1);
}

// robust lock: recover a mutex whose holder died (EOWNERDEAD) — required
// for the kill-a-whole-process drill, where SIGKILL can land mid-match
void rlock(pthread_mutex_t* m) {
  int r = pthread_mutex_lock(m);
  if (r == EOWNERDEAD) pthread_mutex_consistent(m);
}

void init_rmutex(pthread_mutex_t* m) {
  pthread_mutexattr_t a;
  pthread_mutexattr_init(&a);
  pthread_mutexattr_setpshared(&a, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&a, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(m, &a);
  pthread_mutexattr_destroy(&a);
}

uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull +
         static_cast<uint64_t>(ts.tv_nsec);
}

// golden-ratio multiply mix over the four key words (the in-process
// KeyHash, extended with the DESTINATION rank: one shared match space
// serves every rank in the arena, so keys that only differ by receiver —
// a root fanning the same (tag, slot, src) to all children — must land
// in different chains)
inline uint64_t key_hash(uint64_t a, uint64_t b, uint64_t c, uint64_t d) {
  uint64_t h = a * 0x9E3779B97F4A7C15ull;
  h ^= b + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2);
  h ^= c + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2);
  h ^= d + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2);
  return h;
}

inline Shard* shard_of(Att* at, uint64_t h) {
  return at_off<Shard>(at, hdr(at)->off_shards) + (h & (kShards - 1));
}

inline uint64_t* bucket_of(Att* at, uint64_t h) {
  ArenaHdr* hd = hdr(at);
  uint64_t shard = h & (kShards - 1);
  uint64_t bucket = (h >> 4) & (hd->nbuckets - 1);
  return at_off<uint64_t>(at, hd->off_buckets) +
         shard * hd->nbuckets + bucket;
}

inline IpcEntry* entry_at(Att* at, uint64_t off) {
  return at_off<IpcEntry>(at, off);
}

bool is_fenced(Att* at, uint64_t a) {
  ArenaHdr* hd = hdr(at);
  uint64_t team = a >> 32, epoch = a & 0xFFFFFFFFull;
  uint64_t n = hd->fence_n.load(std::memory_order_acquire);
  FenceSlot* f = at_off<FenceSlot>(at, hd->off_fence);
  for (uint64_t i = 0; i < n && i < kFenceCap; ++i)
    if (f[i].team.load(std::memory_order_relaxed) == team)
      return epoch < f[i].min_epoch.load(std::memory_order_relaxed);
  return false;
}

// -- slot plumbing ---------------------------------------------------------

// allocate a request slot: returns rid, 0 on exhaustion. Initial pub is
// (gen << 32) | state (state may be a completed one for immediate
// publication — post_recv matching an unexpected entry completes in-call).
uint64_t slot_alloc(Att* at, uint64_t state_word) {
  ArenaHdr* hd = hdr(at);
  uint64_t idx;
  if (!at_off<ShmRing>(at, hd->off_slot_ring)->pop(&idx)) return 0;
  uint64_t* gen_arr = at_off<uint64_t>(at, hd->off_gen);
  uint64_t gen = ++gen_arr[idx] & 0xFFFFFFFFull;
  if (gen == 0) gen = ++gen_arr[idx] & 0xFFFFFFFFull;  // keep rid nonzero
  std::atomic<uint64_t>* pub =
      at_off<std::atomic<uint64_t>>(at, hd->off_pub) + idx;
  pub->store((gen << 32) | state_word, std::memory_order_release);
  hd->ctr[C_SLOTS_LIVE].fetch_add(1, std::memory_order_relaxed);
  return (gen << kSlotBits) | idx;
}

inline std::atomic<uint64_t>* pub_of(Att* at, uint64_t idx) {
  return at_off<std::atomic<uint64_t>>(at, hdr(at)->off_pub) + idx;
}

// publish completion into a slot, preserving its current generation
void slot_publish(Att* at, uint64_t rid, uint64_t nbytes, uint64_t state) {
  uint64_t idx = rid & kIdxMask;
  uint64_t gen = (rid >> kSlotBits) & 0xFFFFFFFFull;
  uint64_t nb = nbytes < kNbMax ? nbytes : kNbMax;
  at_off<uint64_t>(at, hdr(at)->off_nb)[idx] = nbytes;
  pub_of(at, idx)->store((gen << 32) | (nb << 3) | state,
                         std::memory_order_release);
}

// -- payload-block allocator -----------------------------------------------

// pop a block from the smallest class that fits; the returned offset
// points at the data area (the class index rides in the 64-byte header)
uint64_t block_alloc(Att* at, uint64_t nbytes) {
  ArenaHdr* hd = hdr(at);
  for (uint64_t c = 0; c < kNumClasses; ++c) {
    if (nbytes > hd->class_size[c]) continue;
    uint64_t off;
    if (at_off<ShmRing>(at, hd->off_class_ring[c])->pop(&off)) {
      hd->ctr[C_BLOCKS_LIVE].fetch_add(1, std::memory_order_relaxed);
      return off;
    }
    // class exhausted: try the next larger one rather than failing
  }
  hd->ctr[C_ALLOC_FAIL].fetch_add(1, std::memory_order_relaxed);
  return 0;
}

void block_free(Att* at, uint64_t off) {
  if (!off) return;
  ArenaHdr* hd = hdr(at);
  uint64_t cls = *at_off<uint64_t>(at, off - 64);
  if (cls < kNumClasses) {
    at_off<ShmRing>(at, hd->off_class_ring[cls])->push(off);
    hd->ctr[C_BLOCKS_LIVE].fetch_sub(1, std::memory_order_relaxed);
  }
}

uint64_t entry_alloc(Att* at) {
  uint64_t off;
  if (!at_off<ShmRing>(at, hdr(at)->off_entry_ring)->pop(&off)) return 0;
  return off;
}

void entry_free(Att* at, uint64_t off) {
  at_off<ShmRing>(at, hdr(at)->off_entry_ring)->push(off);
}

// deliver an unexpected entry into a posted destination (both arena
// offsets). Called under the shard lock. Returns the receiver pub state.
uint64_t deliver(Att* at, IpcEntry* unexp, uint64_t dst_off,
                 uint64_t dst_cap, uint64_t* out_nbytes) {
  ArenaHdr* hd = hdr(at);
  uint64_t n = unexp->nbytes;
  uint64_t copied = n <= dst_cap ? n : dst_cap;
  memcpy(at->base + dst_off, at->base + unexp->data_off, copied);
  hd->ctr[C_BYTES].fetch_add(copied, std::memory_order_relaxed);
  uint64_t state = n > dst_cap ? kTruncated : kOk;
  if (state == kOk && (unexp->crc_word >> 32)) {
    // verify over the DELIVERED copy: a tear in either cross-process
    // memcpy (sender->block, block->dst) fails exactly this request
    if (crc32_of(at->base + dst_off, copied) !=
        (unexp->crc_word & 0xFFFFFFFFull)) {
      state = kCorrupt;
      hd->ctr[C_CORRUPT].fetch_add(1, std::memory_order_relaxed);
      // attribution: the pub nbytes field carries the sender's ctx rank
      copied = unexp->kc & 0xFFFFFFFFull;
    }
  }
  if (state == kTruncated)
    hd->ctr[C_TRUNCATED].fetch_add(1, std::memory_order_relaxed);
  *out_nbytes = state == kCorrupt ? (unexp->kc & 0xFFFFFFFFull)
                                  : (state == kTruncated ? copied : n);
  return state;
}

}  // namespace

extern "C" {

void ucc_ipc_req_free(void* hp, uint64_t rid);

// ---------------------------------------------------------------------------
// attach / detach / identity
// ---------------------------------------------------------------------------

// Attach-or-create the named arena (shm_open under /dev/shm). The first
// process in wins creation (O_EXCL), sizes the segment from *heap_bytes*
// (payload heap; match tables and slots are fixed-capacity on top) and
// publishes header.ready; attachers spin on it briefly. Returns NULL on
// any failure — callers fall back to socket transport.
void* ucc_mailbox_attach(const char* shm_name, uint64_t heap_bytes,
                         uint64_t win_bytes) {
  if (!shm_name || !*shm_name) return nullptr;
  if (heap_bytes < (16ull << 20)) heap_bytes = 16ull << 20;
  if (win_bytes < (1ull << 20)) win_bytes = 1ull << 20;

  // ---- compute the layout (identical in every process) ----
  uint64_t class_cnt[kNumClasses];
  class_cnt[0] = heap_bytes / 8 / kClassSizes[0];          // 4 KiB
  class_cnt[1] = heap_bytes / 4 / kClassSizes[1];          // 64 KiB
  class_cnt[2] = heap_bytes * 3 / 8 / kClassSizes[2];      // 1 MiB
  class_cnt[3] = heap_bytes / 4 / kClassSizes[3];          // 8 MiB
  for (uint64_t c = 0; c < kNumClasses; ++c)
    if (class_cnt[c] < 2) class_cnt[c] = 2;

  uint64_t off = align_up(sizeof(ArenaHdr), 64);
  uint64_t off_shards = off; off += kShards * sizeof(Shard);
  off = align_up(off, 64);
  uint64_t off_fence = off; off += kFenceCap * sizeof(FenceSlot);
  off = align_up(off, 64);
  uint64_t off_pids = off; off += kMaxRanks * sizeof(PidSlot);
  off = align_up(off, 64);
  uint64_t off_intern = off; off += kInternCap * sizeof(InternSlot);
  off = align_up(off, 64);
  uint64_t off_windows = off; off += kWindowCap * sizeof(WindowSlot);
  off = align_up(off, 64);
  uint64_t off_buckets = off; off += kShards * kBuckets * 8;
  off = align_up(off, 64);
  uint64_t off_pub = off; off += kSlotCap * 8;
  uint64_t off_gen = off; off += kSlotCap * 8;
  uint64_t off_nb = off; off += kSlotCap * 8;
  uint64_t off_sent = off; off += kSlotCap * 8;
  off = align_up(off, 64);
  uint64_t off_slot_ring = off; off += ShmRing::bytes_for(kSlotCap);
  off = align_up(off, 64);
  uint64_t off_entry_ring = off; off += ShmRing::bytes_for(kEntryCap);
  off = align_up(off, 64);
  uint64_t off_entries = off;
  off += kEntryCap * align_up(sizeof(IpcEntry), 128);
  uint64_t off_class_ring[kNumClasses];
  uint64_t ring_cap[kNumClasses];
  for (uint64_t c = 0; c < kNumClasses; ++c) {
    uint64_t cap = 2;
    while (cap < class_cnt[c] + 1) cap <<= 1;
    ring_cap[c] = cap;
    off = align_up(off, 64);
    off_class_ring[c] = off;
    off += ShmRing::bytes_for(cap);
  }
  off = align_up(off, 4096);
  uint64_t off_blocks = off;
  for (uint64_t c = 0; c < kNumClasses; ++c)
    off += class_cnt[c] * (kClassSizes[c] + 64);
  off = align_up(off, 4096);
  uint64_t off_winheap = off; off += win_bytes;
  uint64_t total = align_up(off, 4096);

  // ---- create or attach ----
  Att* at = new (std::nothrow) Att();
  if (!at) return nullptr;
  snprintf(at->name, sizeof(at->name), "%s", shm_name);
  at->integrity = 0;
  int fd = shm_open(shm_name, O_RDWR | O_CREAT | O_EXCL, 0600);
  at->created = fd >= 0;
  if (fd < 0) {
    if (errno != EEXIST) { delete at; return nullptr; }
    fd = shm_open(shm_name, O_RDWR, 0600);
    if (fd < 0) { delete at; return nullptr; }
    // wait for the creator to ftruncate (size appears atomically)
    struct stat st;
    for (int spin = 0; spin < 20000; ++spin) {
      if (fstat(fd, &st) == 0 && static_cast<uint64_t>(st.st_size) >= total)
        break;
      usleep(500);
    }
    if (fstat(fd, &st) != 0 ||
        static_cast<uint64_t>(st.st_size) < sizeof(ArenaHdr)) {
      close(fd); delete at; return nullptr;
    }
    total = static_cast<uint64_t>(st.st_size);
  } else if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    close(fd); shm_unlink(shm_name); delete at;
    return nullptr;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                    fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    if (at->created) shm_unlink(shm_name);
    delete at;
    return nullptr;
  }
  at->base = static_cast<char*>(base);
  at->len = total;
  ArenaHdr* hd = hdr(at);

  if (at->created) {
    memset(static_cast<void*>(hd), 0, sizeof(ArenaHdr));
    hd->abi = kArenaAbi;
    hd->total_bytes = total;
    hd->creator_pid = static_cast<uint64_t>(getpid());
    hd->slot_cap = kSlotCap;
    hd->entry_cap = kEntryCap;
    hd->nshards = kShards;
    hd->nbuckets = kBuckets;
    hd->win_bytes = win_bytes;
    hd->win_bump.store(0, std::memory_order_relaxed);
    for (uint64_t c = 0; c < kNumClasses; ++c) {
      hd->class_size[c] = kClassSizes[c];
      hd->class_cnt[c] = class_cnt[c];
      hd->off_class_ring[c] = off_class_ring[c];
    }
    hd->off_shards = off_shards; hd->off_fence = off_fence;
    hd->off_pids = off_pids; hd->off_intern = off_intern;
    hd->off_windows = off_windows; hd->off_buckets = off_buckets;
    hd->off_pub = off_pub; hd->off_gen = off_gen; hd->off_nb = off_nb;
    hd->off_sent = off_sent; hd->off_slot_ring = off_slot_ring;
    hd->off_entry_ring = off_entry_ring; hd->off_entries = off_entries;
    hd->off_blocks = off_blocks; hd->off_winheap = off_winheap;
    init_rmutex(&hd->big_mu);
    Shard* sh = at_off<Shard>(at, off_shards);
    for (uint64_t i = 0; i < kShards; ++i) init_rmutex(&sh[i].mu);
    memset(at->base + off_fence, 0, kFenceCap * sizeof(FenceSlot));
    memset(at->base + off_pids, 0, kMaxRanks * sizeof(PidSlot));
    memset(at->base + off_intern, 0, kInternCap * sizeof(InternSlot));
    memset(at->base + off_windows, 0, kWindowCap * sizeof(WindowSlot));
    memset(at->base + off_buckets, 0, kShards * kBuckets * 8);
    memset(at->base + off_pub, 0, kSlotCap * 8 * 4);
    ShmRing* sring = at_off<ShmRing>(at, off_slot_ring);
    sring->init(kSlotCap);
    for (uint64_t i = 1; i < kSlotCap; ++i) sring->push(i);  // idx 0: rid!=0
    ShmRing* ering = at_off<ShmRing>(at, off_entry_ring);
    ering->init(kEntryCap);
    uint64_t estride = align_up(sizeof(IpcEntry), 128);
    for (uint64_t i = 0; i < kEntryCap; ++i)
      ering->push(off_entries + i * estride);
    uint64_t boff = off_blocks;
    for (uint64_t c = 0; c < kNumClasses; ++c) {
      ShmRing* r = at_off<ShmRing>(at, off_class_ring[c]);
      r->init(ring_cap[c]);
      for (uint64_t i = 0; i < class_cnt[c]; ++i) {
        *at_off<uint64_t>(at, boff) = c;  // class tag in the block header
        r->push(boff + 64);
        boff += kClassSizes[c] + 64;
      }
    }
    hd->magic = kArenaMagic;
    hd->ready.store(1, std::memory_order_release);
  } else {
    // attacher: wait for the creator's init to land, then sanity-gate
    bool ok = false;
    for (int spin = 0; spin < 20000; ++spin) {
      if (hd->ready.load(std::memory_order_acquire) == 1) { ok = true; break; }
      usleep(500);
    }
    if (!ok || hd->magic != kArenaMagic || hd->abi != kArenaAbi) {
      munmap(at->base, at->len);
      delete at;
      return nullptr;
    }
  }
  hd->ctr[C_ATTACHES].fetch_add(1, std::memory_order_relaxed);
  return at;
}

// Reaper probe: open an EXISTING segment read-only, report the creator
// pid and every registered rank pid without the attach-time ready spin.
// Returns 1 + number of registered pids written to out[1..]; out[0] is
// the creator pid. Returns 0 when the segment is missing, not yet
// initialized (leave it alone — someone may be mid-create), or not an
// arena at all (never unlink what we can't identify).
uint64_t ucc_arena_probe(const char* name, uint64_t* out, uint64_t cap) {
  int fd = shm_open(name, O_RDONLY, 0);
  if (fd < 0) return 0;
  struct stat st;
  if (fstat(fd, &st) != 0 ||
      static_cast<uint64_t>(st.st_size) < sizeof(ArenaHdr)) {
    close(fd);
    return 0;
  }
  void* base = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                    MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return 0;
  ArenaHdr* hd = static_cast<ArenaHdr*>(base);
  uint64_t n = 0;
  if (hd->magic == kArenaMagic && hd->abi == kArenaAbi &&
      hd->ready.load(std::memory_order_acquire) == 1 && cap >= 1) {
    out[0] = hd->creator_pid;
    n = 1;
    PidSlot* pids = reinterpret_cast<PidSlot*>(
        static_cast<char*>(base) + hd->off_pids);
    for (uint64_t r = 0; r < kMaxRanks && n < cap; ++r) {
      uint64_t pid = pids[r].pid.load(std::memory_order_relaxed);
      if (pid) out[n++] = pid;
    }
  }
  munmap(base, static_cast<size_t>(st.st_size));
  return n;
}

void ucc_arena_detach(void* hp, int unlink) {
  Att* at = static_cast<Att*>(hp);
  if (!at) return;
  if (unlink) shm_unlink(at->name);
  munmap(at->base, at->len);
  delete at;
}

uint64_t ucc_arena_created(void* hp) {
  return static_cast<Att*>(hp)->created ? 1 : 0;
}

uint64_t ucc_arena_total_bytes(void* hp) {
  return hdr(static_cast<Att*>(hp))->total_bytes;
}

uint64_t ucc_arena_creator_pid(void* hp) {
  return hdr(static_cast<Att*>(hp))->creator_pid;
}

void* ucc_ipc_pub_base(void* hp) {
  Att* at = static_cast<Att*>(hp);
  return at->base + hdr(at)->off_pub;
}

uint64_t ucc_ipc_slot_cap(void* hp) {
  return hdr(static_cast<Att*>(hp))->slot_cap;
}

void ucc_ipc_set_integrity(void* hp, uint64_t on) {
  static_cast<Att*>(hp)->integrity = on;
}

uint64_t ucc_arena_max_msg(void* hp) {
  return hdr(static_cast<Att*>(hp))->class_size[kNumClasses - 1];
}

// ---------------------------------------------------------------------------
// liveness board (cross-process heartbeats + pid registration)
// ---------------------------------------------------------------------------

uint64_t ucc_arena_register(void* hp, uint64_t ctx_rank, uint64_t pid) {
  Att* at = static_cast<Att*>(hp);
  if (ctx_rank >= kMaxRanks) return 0;
  PidSlot* p = at_off<PidSlot>(at, hdr(at)->off_pids) + ctx_rank;
  p->beat_ns.store(now_ns(), std::memory_order_relaxed);
  p->pid.store(pid, std::memory_order_release);
  return 1;
}

void ucc_arena_beat(void* hp, uint64_t ctx_rank) {
  Att* at = static_cast<Att*>(hp);
  if (ctx_rank >= kMaxRanks) return;
  PidSlot* p = at_off<PidSlot>(at, hdr(at)->off_pids) + ctx_rank;
  p->beat_ns.store(now_ns(), std::memory_order_release);
}

uint64_t ucc_arena_peer_pid(void* hp, uint64_t ctx_rank) {
  Att* at = static_cast<Att*>(hp);
  if (ctx_rank >= kMaxRanks) return 0;
  return (at_off<PidSlot>(at, hdr(at)->off_pids) + ctx_rank)
      ->pid.load(std::memory_order_acquire);
}

// milliseconds since *ctx_rank* last beat; ~0ull when it never registered
uint64_t ucc_arena_beat_age_ms(void* hp, uint64_t ctx_rank) {
  Att* at = static_cast<Att*>(hp);
  if (ctx_rank >= kMaxRanks) return ~0ull;
  PidSlot* p = at_off<PidSlot>(at, hdr(at)->off_pids) + ctx_rank;
  if (p->pid.load(std::memory_order_acquire) == 0) return ~0ull;
  uint64_t last = p->beat_ns.load(std::memory_order_acquire);
  uint64_t now = now_ns();
  return now > last ? (now - last) / 1000000ull : 0;
}

// ---------------------------------------------------------------------------
// cross-process key interning — deterministic byte strings -> stable ids
// ---------------------------------------------------------------------------

uint64_t ucc_arena_intern(void* hp, const void* bytes, uint64_t len) {
  Att* at = static_cast<Att*>(hp);
  ArenaHdr* hd = hdr(at);
  if (len == 0 || len > kInternBytes) return 0;
  InternSlot* tab = at_off<InternSlot>(at, hd->off_intern);
  rlock(&hd->big_mu);
  uint64_t id = 0;
  for (uint64_t i = 0; i < kInternCap; ++i) {
    if (tab[i].len == 0) {
      tab[i].len = len;
      memcpy(tab[i].bytes, bytes, len);
      hd->ctr[C_INTERN_N].fetch_add(1, std::memory_order_relaxed);
      id = i + 2;  // 0 = failure, 1 = reserved
      break;
    }
    if (tab[i].len == len && memcmp(tab[i].bytes, bytes, len) == 0) {
      id = i + 2;
      break;
    }
  }
  pthread_mutex_unlock(&hd->big_mu);
  return id;
}

// ---------------------------------------------------------------------------
// payload heap (recv bounce buffers) + pooled-tier windows
// ---------------------------------------------------------------------------

uint64_t ucc_arena_alloc(void* hp, uint64_t nbytes) {
  return block_alloc(static_cast<Att*>(hp), nbytes ? nbytes : 1);
}

void ucc_arena_free(void* hp, uint64_t off) {
  block_free(static_cast<Att*>(hp), off);
}

void* ucc_arena_base(void* hp) { return static_cast<Att*>(hp)->base; }

// get-or-create a persistent named window in the window heap (pooled
// collectives reduce through it; persists for the arena's life)
uint64_t ucc_arena_window(void* hp, uint64_t key, uint64_t nbytes) {
  Att* at = static_cast<Att*>(hp);
  ArenaHdr* hd = hdr(at);
  if (!key || !nbytes) return 0;
  WindowSlot* tab = at_off<WindowSlot>(at, hd->off_windows);
  rlock(&hd->big_mu);
  uint64_t off = 0;
  for (uint64_t i = 0; i < kWindowCap; ++i) {
    if (tab[i].key == key && tab[i].nbytes >= nbytes) {
      off = tab[i].off;
      break;
    }
    if (tab[i].key == 0) {
      uint64_t want = align_up(nbytes, 64);
      uint64_t bump = hd->win_bump.load(std::memory_order_relaxed);
      if (bump + want <= hd->win_bytes) {
        tab[i].key = key;
        tab[i].off = hd->off_winheap + bump;
        tab[i].nbytes = want;
        hd->win_bump.store(bump + want, std::memory_order_relaxed);
        hd->ctr[C_WINDOW_N].fetch_add(1, std::memory_order_relaxed);
        hd->ctr[C_WIN_BYTES].fetch_add(want, std::memory_order_relaxed);
        memset(at->base + tab[i].off, 0, want);
        off = tab[i].off;
      }
      break;
    }
  }
  pthread_mutex_unlock(&hd->big_mu);
  if (!off) hd->ctr[C_ALLOC_FAIL].fetch_add(1, std::memory_order_relaxed);
  return off;
}

// release-ordered u64 store / acquire-ordered load at an arena offset:
// the pooled put+flag executors stamp and poll flag words through these
// so payload-before-flag ordering holds on every architecture, not just
// TSO x86
void ucc_arena_store_release(void* hp, uint64_t off, uint64_t val) {
  Att* at = static_cast<Att*>(hp);
  reinterpret_cast<std::atomic<uint64_t>*>(at->base + off)
      ->store(val, std::memory_order_release);
}

uint64_t ucc_arena_load_acquire(void* hp, uint64_t off) {
  Att* at = static_cast<Att*>(hp);
  return reinterpret_cast<std::atomic<uint64_t>*>(at->base + off)
      ->load(std::memory_order_acquire);
}

// ---------------------------------------------------------------------------
// the data path
// ---------------------------------------------------------------------------

// Send: match a posted recv (direct delivery: memcpy sender->registered
// dst under the shard lock, publish the receiver's completion) or park
// an unexpected entry (eager <= limit completes now; rndv keeps the
// sender pending until delivery). Returns (rid << 3) | kind; rid is
// nonzero only for rndv. kKindNoMem = payload heap exhausted.
uint64_t ucc_ipc_push(void* hp, uint64_t a, uint64_t b, uint64_t c,
                      uint64_t dst_rank, const void* src, uint64_t nbytes,
                      uint64_t eager_limit, uint64_t crc_word) {
  Att* at = static_cast<Att*>(hp);
  ArenaHdr* hd = hdr(at);
  if (is_fenced(at, a)) {
    hd->ctr[C_FENCED].fetch_add(1, std::memory_order_relaxed);
    return kKindFenced;
  }
  if (at->integrity && !(crc_word >> 32))
    crc_word = (1ull << 32) | crc32_of(src, nbytes);
  uint64_t h = key_hash(a, b, c, dst_rank);
  Shard* sh = shard_of(at, h);
  uint64_t* bucket = bucket_of(at, h);
  rlock(&sh->mu);
  uint64_t prev = 0, eo = *bucket;
  while (eo) {
    IpcEntry* e = entry_at(at, eo);
    if (e->kind == 1 && e->ka == a && e->kb == b && e->kc == c &&
        e->kd == dst_rank && !(e->flags & 1))
      break;
    prev = eo;
    eo = e->next;
  }
  if (eo) {
    // ---- direct delivery: copy into the posted destination in-call ----
    IpcEntry* e = entry_at(at, eo);
    if (prev)
      entry_at(at, prev)->next = e->next;
    else
      *bucket = e->next;
    uint64_t cap = e->nbytes;
    uint64_t copied = nbytes <= cap ? nbytes : cap;
    memcpy(at->base + e->data_off, src, copied);
    uint64_t state = nbytes > cap ? kTruncated : kOk;
    uint64_t pub_nb = nbytes;
    if (state == kOk && (crc_word >> 32) &&
        crc32_of(at->base + e->data_off, copied) !=
            (crc_word & 0xFFFFFFFFull)) {
      state = kCorrupt;
      pub_nb = c & 0xFFFFFFFFull;  // sender ctx rank for attribution
      hd->ctr[C_CORRUPT].fetch_add(1, std::memory_order_relaxed);
    }
    if (state == kTruncated) {
      at_off<uint64_t>(at, hd->off_sent)[e->rid & kIdxMask] = nbytes;
      pub_nb = copied;
      hd->ctr[C_TRUNCATED].fetch_add(1, std::memory_order_relaxed);
    }
    uint64_t rid = e->rid;
    entry_free(at, eo);
    hd->ctr[C_POSTED].fetch_sub(1, std::memory_order_relaxed);
    hd->ctr[C_DIRECT].fetch_add(1, std::memory_order_relaxed);
    hd->ctr[C_BYTES].fetch_add(copied, std::memory_order_relaxed);
    slot_publish(at, rid, pub_nb, state);
    pthread_mutex_unlock(&sh->mu);
    return kKindDirect;
  }
  // ---- unexpected: stage the payload into an arena block ----
  uint64_t blk = block_alloc(at, nbytes ? nbytes : 1);
  if (!blk && nbytes) {
    pthread_mutex_unlock(&sh->mu);
    return kKindNoMem;
  }
  uint64_t kind = nbytes <= eager_limit ? kKindEager : kKindRndv;
  uint64_t rid = 0;
  if (kind == kKindRndv) {
    rid = slot_alloc(at, 0);
    if (!rid) kind = kKindEager;  // slot exhaustion degrades rndv->eager
  }
  uint64_t ent = entry_alloc(at);
  if (!ent) {
    block_free(at, blk);
    if (rid) {
      slot_publish(at, rid, 0, kCanceled);
      // slot is freed by nobody (sender never learns the rid): reclaim
      ucc_ipc_req_free(hp, rid);
    }
    pthread_mutex_unlock(&sh->mu);
    return kKindNoMem;
  }
  if (nbytes) memcpy(at->base + blk, src, nbytes);
  IpcEntry* e = entry_at(at, ent);
  e->ka = a; e->kb = b; e->kc = c; e->kd = dst_rank;
  e->kind = 2;
  e->data_off = blk;
  e->nbytes = nbytes;
  e->rid = kind == kKindRndv ? rid : 0;
  e->crc_word = crc_word;
  e->flags = 0;
  e->next = *bucket;
  *bucket = ent;  // publish the head LAST: the chain stays walkable
  hd->ctr[C_UNEXP].fetch_add(1, std::memory_order_relaxed);
  hd->ctr[kind == kKindRndv ? C_RNDV : C_EAGER].fetch_add(
      1, std::memory_order_relaxed);
  pthread_mutex_unlock(&sh->mu);
  return (rid << 3) | kind;
}

// Post a receive: *dst_off* is an arena offset (the python side stages
// through an arena bounce block, or passes a window offset for true
// zero-copy). Returns the rid (poll the mapped pub word), 0 = slots or
// memory exhausted. An unexpected match completes inside this call.
uint64_t ucc_ipc_post_recv(void* hp, uint64_t a, uint64_t b, uint64_t c,
                           uint64_t dst_rank, uint64_t dst_off,
                           uint64_t nbytes) {
  Att* at = static_cast<Att*>(hp);
  ArenaHdr* hd = hdr(at);
  if (is_fenced(at, a)) {
    hd->ctr[C_FENCED].fetch_add(1, std::memory_order_relaxed);
    uint64_t rid = slot_alloc(at, kFenced);
    return rid;
  }
  uint64_t h = key_hash(a, b, c, dst_rank);
  Shard* sh = shard_of(at, h);
  uint64_t* bucket = bucket_of(at, h);
  rlock(&sh->mu);
  uint64_t prev = 0, eo = *bucket;
  while (eo) {
    IpcEntry* e = entry_at(at, eo);
    if (e->kind == 2 && e->ka == a && e->kb == b && e->kc == c &&
        e->kd == dst_rank)
      break;
    prev = eo;
    eo = e->next;
  }
  if (eo) {
    // ---- unexpected match: deliver block -> dst now ----
    IpcEntry* e = entry_at(at, eo);
    if (prev)
      entry_at(at, prev)->next = e->next;
    else
      *bucket = e->next;
    uint64_t pub_nb = 0;
    uint64_t state = deliver(at, e, dst_off, nbytes, &pub_nb);
    uint64_t rid = slot_alloc(at, (pub_nb < kNbMax ? pub_nb : kNbMax) << 3
                                      | state);
    if (rid) {
      at_off<uint64_t>(at, hd->off_nb)[rid & kIdxMask] = pub_nb;
      if (state == kTruncated)
        at_off<uint64_t>(at, hd->off_sent)[rid & kIdxMask] = e->nbytes;
    }
    if (e->rid)  // rndv: complete the parked sender at delivery
      slot_publish(at, e->rid, e->nbytes, state == kCorrupt ? kCorrupt : kOk);
    block_free(at, e->data_off);
    entry_free(at, eo);
    hd->ctr[C_UNEXP].fetch_sub(1, std::memory_order_relaxed);
    pthread_mutex_unlock(&sh->mu);
    return rid;
  }
  // ---- park the posted recv ----
  uint64_t rid = slot_alloc(at, 0);
  if (!rid) {
    pthread_mutex_unlock(&sh->mu);
    return 0;
  }
  uint64_t ent = entry_alloc(at);
  if (!ent) {
    slot_publish(at, rid, 0, kCanceled);
    ucc_ipc_req_free(hp, rid);
    pthread_mutex_unlock(&sh->mu);
    return 0;
  }
  IpcEntry* e = entry_at(at, ent);
  e->ka = a; e->kb = b; e->kc = c; e->kd = dst_rank;
  e->kind = 1;
  e->data_off = dst_off;
  e->nbytes = nbytes;
  e->rid = rid;
  e->crc_word = 0;
  e->flags = 0;
  e->next = *bucket;
  *bucket = ent;
  hd->ctr[C_POSTED].fetch_add(1, std::memory_order_relaxed);
  pthread_mutex_unlock(&sh->mu);
  return rid;
}

// acquire-ordered completion confirm (the mapped pub read is the cheap
// hint; this is the once-per-request-lifetime barrier). 0 = pending.
uint64_t ucc_ipc_req_poll(void* hp, uint64_t rid) {
  Att* at = static_cast<Att*>(hp);
  uint64_t idx = rid & kIdxMask;
  if (idx >= hdr(at)->slot_cap) return 1;
  uint64_t v = pub_of(at, idx)->load(std::memory_order_acquire);
  if ((v >> 32) != ((rid >> kSlotBits) & 0xFFFFFFFFull))
    return 1;  // slot freed/recycled under us: freed == complete
  return (v & 7) ? v : 0;
}

uint64_t ucc_ipc_req_nbytes(void* hp, uint64_t rid) {
  Att* at = static_cast<Att*>(hp);
  uint64_t idx = rid & kIdxMask;
  if (idx >= hdr(at)->slot_cap) return 0;
  return at_off<uint64_t>(at, hdr(at)->off_nb)[idx];
}

uint64_t ucc_ipc_req_sent_nbytes(void* hp, uint64_t rid) {
  Att* at = static_cast<Att*>(hp);
  uint64_t idx = rid & kIdxMask;
  if (idx >= hdr(at)->slot_cap) return 0;
  return at_off<uint64_t>(at, hdr(at)->off_sent)[idx];
}

// withdraw a posted recv: the entry is unlinked under the same shard
// lock that matches, so cancel-vs-match cannot interleave. Returns 1
// when withdrawn, 0 when it already delivered (the request keeps its
// delivered result — the python RecvReq.cancel contract).
int ucc_ipc_req_cancel(void* hp, uint64_t a, uint64_t b, uint64_t c,
                       uint64_t dst_rank, uint64_t rid) {
  Att* at = static_cast<Att*>(hp);
  ArenaHdr* hd = hdr(at);
  uint64_t h = key_hash(a, b, c, dst_rank);
  Shard* sh = shard_of(at, h);
  uint64_t* bucket = bucket_of(at, h);
  rlock(&sh->mu);
  uint64_t prev = 0, eo = *bucket;
  while (eo) {
    IpcEntry* e = entry_at(at, eo);
    if (e->kind == 1 && e->rid == rid) {
      if (prev)
        entry_at(at, prev)->next = e->next;
      else
        *bucket = e->next;
      entry_free(at, eo);
      hd->ctr[C_POSTED].fetch_sub(1, std::memory_order_relaxed);
      hd->ctr[C_CANCELED].fetch_add(1, std::memory_order_relaxed);
      slot_publish(at, rid, 0, kCanceled);
      pthread_mutex_unlock(&sh->mu);
      return 1;
    }
    prev = eo;
    eo = e->next;
  }
  pthread_mutex_unlock(&sh->mu);
  return 0;
}

// free a request slot: bump the generation (stale handles then read
// freed == complete) and recycle the index through the slot ring
void ucc_ipc_req_free(void* hp, uint64_t rid) {
  Att* at = static_cast<Att*>(hp);
  ArenaHdr* hd = hdr(at);
  uint64_t idx = rid & kIdxMask;
  if (idx == 0 || idx >= hd->slot_cap) return;
  uint64_t* gen_arr = at_off<uint64_t>(at, hd->off_gen);
  uint64_t cur = pub_of(at, idx)->load(std::memory_order_relaxed);
  if ((cur >> 32) != ((rid >> kSlotBits) & 0xFFFFFFFFull))
    return;  // double free / stale handle: the slot moved on
  uint64_t gen = (++gen_arr[idx]) & 0xFFFFFFFFull;
  pub_of(at, idx)->store(gen << 32 | kCanceled, std::memory_order_release);
  at_off<ShmRing>(at, hd->off_slot_ring)->push(idx);
  hd->ctr[C_SLOTS_LIVE].fetch_sub(1, std::memory_order_relaxed);
}

// ---------------------------------------------------------------------------
// fences / purge
// ---------------------------------------------------------------------------

// install (team, min_epoch) and purge parked stale state: posted recvs
// error kFenced, staged unexpected payloads are freed, parked rndv
// senders complete kFenced. Late stale arrivals are then discarded at
// the match boundary by is_fenced. Returns the number purged.
uint64_t ucc_ipc_fence(void* hp, uint64_t team, uint64_t min_epoch) {
  Att* at = static_cast<Att*>(hp);
  ArenaHdr* hd = hdr(at);
  FenceSlot* f = at_off<FenceSlot>(at, hd->off_fence);
  rlock(&hd->big_mu);
  uint64_t n = hd->fence_n.load(std::memory_order_relaxed);
  uint64_t i = 0;
  for (; i < n; ++i)
    if (f[i].team.load(std::memory_order_relaxed) == team) break;
  if (i == n && n < kFenceCap) {
    f[i].min_epoch.store(0, std::memory_order_relaxed);
    f[i].team.store(team, std::memory_order_relaxed);
    hd->fence_n.store(n + 1, std::memory_order_release);
  }
  if (i < kFenceCap &&
      f[i].min_epoch.load(std::memory_order_relaxed) < min_epoch)
    f[i].min_epoch.store(min_epoch, std::memory_order_relaxed);
  pthread_mutex_unlock(&hd->big_mu);

  uint64_t purged = 0;
  Shard* shards = at_off<Shard>(at, hd->off_shards);
  uint64_t* buckets = at_off<uint64_t>(at, hd->off_buckets);
  for (uint64_t s = 0; s < hd->nshards; ++s) {
    rlock(&shards[s].mu);
    for (uint64_t bkt = 0; bkt < hd->nbuckets; ++bkt) {
      uint64_t* slot = &buckets[s * hd->nbuckets + bkt];
      uint64_t eo = *slot;
      uint64_t prev = 0;
      while (eo) {
        IpcEntry* e = entry_at(at, eo);
        uint64_t next = e->next;
        if ((e->ka >> 32) == team && (e->ka & 0xFFFFFFFFull) < min_epoch) {
          if (prev)
            entry_at(at, prev)->next = next;
          else
            *slot = next;
          if (e->kind == 1) {
            slot_publish(at, e->rid, 0, kFenced);
            hd->ctr[C_POSTED].fetch_sub(1, std::memory_order_relaxed);
          } else {
            if (e->rid) slot_publish(at, e->rid, 0, kFenced);
            block_free(at, e->data_off);
            hd->ctr[C_UNEXP].fetch_sub(1, std::memory_order_relaxed);
          }
          entry_free(at, eo);
          ++purged;
        } else {
          prev = eo;
        }
        eo = next;
      }
    }
    pthread_mutex_unlock(&shards[s].mu);
  }
  hd->ctr[C_FENCED].fetch_add(purged, std::memory_order_relaxed);
  return purged;
}

// reclaim every entry addressed TO *ctx_rank* (endpoint teardown, or a
// rank confirmed dead): its posted recvs are cancelled, unexpected
// payloads parked for it are freed (their rndv senders complete
// kCanceled — nobody will ever consume them). The analog of the
// in-process destroy-time purge, scoped to one rank of the shared arena.
uint64_t ucc_ipc_purge_rank(void* hp, uint64_t ctx_rank) {
  Att* at = static_cast<Att*>(hp);
  ArenaHdr* hd = hdr(at);
  uint64_t purged = 0;
  Shard* shards = at_off<Shard>(at, hd->off_shards);
  uint64_t* buckets = at_off<uint64_t>(at, hd->off_buckets);
  for (uint64_t s = 0; s < hd->nshards; ++s) {
    rlock(&shards[s].mu);
    for (uint64_t bkt = 0; bkt < hd->nbuckets; ++bkt) {
      uint64_t* slot = &buckets[s * hd->nbuckets + bkt];
      uint64_t eo = *slot;
      uint64_t prev = 0;
      while (eo) {
        IpcEntry* e = entry_at(at, eo);
        uint64_t next = e->next;
        if (e->kd == ctx_rank) {
          if (prev)
            entry_at(at, prev)->next = next;
          else
            *slot = next;
          if (e->kind == 1) {
            slot_publish(at, e->rid, 0, kCanceled);
            ucc_ipc_req_free(hp, e->rid);
            hd->ctr[C_POSTED].fetch_sub(1, std::memory_order_relaxed);
          } else {
            if (e->rid) slot_publish(at, e->rid, 0, kCanceled);
            block_free(at, e->data_off);
            hd->ctr[C_UNEXP].fetch_sub(1, std::memory_order_relaxed);
          }
          entry_free(at, eo);
          ++purged;
        } else {
          prev = eo;
        }
        eo = next;
      }
    }
    pthread_mutex_unlock(&shards[s].mu);
  }
  hd->ctr[C_PURGED].fetch_add(purged, std::memory_order_relaxed);
  return purged;
}

// ---------------------------------------------------------------------------
// observability
// ---------------------------------------------------------------------------

void ucc_arena_counters(void* hp, uint64_t* out) {
  Att* at = static_cast<Att*>(hp);
  ArenaHdr* hd = hdr(at);
  for (int i = 0; i < C_COUNT; ++i)
    out[i] = hd->ctr[i].load(std::memory_order_relaxed);
}

// (parked unexpected, posted recvs, live slots, free payload blocks,
// total payload blocks) — the mc_pool-style occupancy gauge the
// watchdog samples
void ucc_arena_occupancy(void* hp, uint64_t* out) {
  Att* at = static_cast<Att*>(hp);
  ArenaHdr* hd = hdr(at);
  out[0] = hd->ctr[C_UNEXP].load(std::memory_order_relaxed);
  out[1] = hd->ctr[C_POSTED].load(std::memory_order_relaxed);
  out[2] = hd->ctr[C_SLOTS_LIVE].load(std::memory_order_relaxed);
  uint64_t total = 0;
  for (uint64_t c = 0; c < kNumClasses; ++c) total += hd->class_cnt[c];
  out[3] = total - hd->ctr[C_BLOCKS_LIVE].load(std::memory_order_relaxed);
  out[4] = total;
}

}  // extern "C"
