// Native host runtime for complexity_tokenizer_tpu.
//
// The reference's hot host paths are Rust (bpe.rs merge loop,
// pretokenizers.rs regex scan).  This C++ library is the equivalent native
// tier for the *host* side of the TPU framework: it implements the same
// GPT-2 simplified pre-split (local boundary rules over UTF-8 bytes,
// identical to ops/presplit.py), byte->token seeding with silent OOV drop
// (bpe.rs:94-97), and the leftmost-lowest-rank merge loop (bpe.rs:104-153),
// plus batch packing into padded byte matrices for device dispatch.
//
// Exposed via a C ABI for ctypes; semantics are diff-tested against the
// Python oracle in tests/test_native.py.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#ifndef _WIN32
#include <pthread.h>
#endif
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#define CTOK_SSE2 1
#endif

#if defined(__AVX512BW__) && defined(__AVX512VL__)
#include <immintrin.h>
#define CTOK_AVX512 1
#endif

namespace {

#ifdef CTOK_COUNTERS
int64_t g_front_hit = 0, g_front_miss = 0, g_keyed = 0;
#endif

// Persistent worker pool: every batch entry point fans out through this
// instead of spawning std::threads per call (thread creation costs more
// than an entire warm 10K-text encode pass).  The calling thread runs
// shard 0 itself, so run(n) keeps exactly n runnable threads — no
// oversubscription on small hosts.  run() is serialized internally, so
// concurrent callers queue rather than interleave shards.
class ThreadPool {
  public:
    void run(int n, const std::function<void(int)>& fn) {
        if (n <= 1) {
            fn(0);
            return;
        }
        std::lock_guard<std::mutex> outer(run_mu_);
        ensure(n - 1);
        {
            std::lock_guard<std::mutex> lk(mu_);
            job_ = &fn;
            n_active_ = n - 1;
            n_done_ = 0;
            ++epoch_;
        }
        cv_.notify_all();
        fn(0);
        std::unique_lock<std::mutex> lk(mu_);
        cv_done_.wait(lk, [&] { return n_done_ == n_active_; });
        job_ = nullptr;
    }

    ~ThreadPool() {
        {
            std::lock_guard<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& t : workers_) t.join();
    }

  private:
    void ensure(int n_workers) {
        while ((int)workers_.size() < n_workers) {
            int idx = (int)workers_.size();
            workers_.emplace_back([this, idx] { loop(idx); });
        }
    }

    void loop(int idx) {
        uint64_t seen = 0;
        for (;;) {
            const std::function<void(int)>* job;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [&] {
                    return stop_ || (epoch_ != seen && idx < n_active_);
                });
                if (stop_) return;
                seen = epoch_;
                job = job_;
            }
            (*job)(idx + 1);
            {
                std::lock_guard<std::mutex> lk(mu_);
                ++n_done_;
            }
            cv_done_.notify_one();
        }
    }

    std::mutex run_mu_;  // serializes whole run() invocations
    std::mutex mu_;
    std::condition_variable cv_, cv_done_;
    std::vector<std::thread> workers_;
    const std::function<void(int)>* job_ = nullptr;
    uint64_t epoch_ = 0;
    int n_active_ = 0;
    int n_done_ = 0;
    bool stop_ = false;
};

// The pool is heap-allocated and intentionally leaked: parked raw C++
// threads at process exit are harmless (nothing force-unwinds them), and
// skipping static destruction avoids teardown-order hazards.  A forked
// child inherits the bookkeeping but none of the worker threads, so the
// atfork child handler marks the pool stale (an atomic store — the only
// async-signal-safe thing a post-fork handler may do) and pool() rebuilds
// it lazily on first use in the child; otherwise any multi-threaded
// native call there (fork-based multiprocessing is the Linux default)
// would wait forever on workers that do not exist.

// Upper byte-offset bound (exclusive) of thread tid's shard in the
// balanced-by-byte-volume partition.  The last shard includes
// offset == total so zero-length trailing rows (start == total) are
// always assigned to exactly one thread.
inline int64_t shard_hi(int64_t total, int tid, int n_threads) {
    return tid == n_threads - 1 ? total + 1
                                : total * (tid + 1) / n_threads;
}

ThreadPool* g_pool = nullptr;
std::atomic<bool> g_pool_stale{false};

ThreadPool& pool() {
    static std::once_flag once;
    std::call_once(once, [] {
        g_pool = new ThreadPool();
#ifndef _WIN32
        pthread_atfork(nullptr, nullptr,
                       [] { g_pool_stale.store(true); });
#endif
    });
    if (g_pool_stale.exchange(false)) g_pool = new ThreadPool();
    return *g_pool;
}

// Reusable uninitialized POD buffer: new[] without value-init, grown
// geometrically and kept across calls — per-call fresh mallocs of
// multi-MB scratch cost more in page faults than the encode itself.
// One outlier batch must not pin its high-water mark for the context
// lifetime, so a large arena shrinks once steady demand drops well
// below it.
template <typename T>
struct Arena {
    static constexpr size_t kShrinkBytes = 64u << 20;  // 64 MB
    static constexpr int kShrinkAfter = 8;  // consecutive low-demand calls
    std::unique_ptr<T[]> data;
    size_t cap = 0;
    int low_streak = 0;
    T* ensure(size_t n) {
        // shrink only after a sustained drop, so alternating large/small
        // batches don't reallocate every call
        bool low = cap > kShrinkBytes / sizeof(T) && n < cap / 4;
        low_streak = low ? low_streak + 1 : 0;
        if (n > cap || low_streak >= kShrinkAfter) {
            size_t want = 4096;
            while (want < n) want *= 2;
            data.reset(new T[want]);
            cap = want;
            low_streak = 0;
        }
        return data.get();
    }
};

struct PairKey {
    uint64_t v;
    bool operator==(const PairKey& o) const { return v == o.v; }
};

struct PairKeyHash {
    size_t operator()(const PairKey& k) const {
        uint64_t h = k.v * 0x9E3779B97F4A7C15ull;
        h ^= h >> 29;
        return (size_t)h;
    }
};

// Flat open-addressing pair->rank table: the merge loop probes this on
// every adjacent pair, so the node-based std::unordered_map's pointer
// chase is the dominant cold-path cost.  Keys are (a<<32)|b with a,b >= 0,
// so ~0 is a safe empty marker.
struct RankTable {
    // interleaved 16-byte entries: a probe touches exactly one cache
    // line (the old keys[]/vals[] split cost two on every hit)
    struct alignas(16) Entry {
        uint64_t key;
        int32_t val;
        int32_t _pad;
    };
    std::vector<Entry> entries;
    uint64_t mask = 0;
    static constexpr uint64_t kEmpty = ~0ull;

    static inline uint64_t hash(uint64_t k) {
        uint64_t h = k * 0x9E3779B97F4A7C15ull;
        return h ^ (h >> 32);
    }

    void build(int64_t n_pairs, const int32_t* pa, const int32_t* pb,
               const int32_t* pr) {
        size_t cap = 64;
        while ((int64_t)cap < n_pairs * 2) cap *= 2;
        entries.assign(cap, Entry{kEmpty, -1, 0});
        mask = cap - 1;
        for (int64_t i = 0; i < n_pairs; ++i) {
            uint64_t k = (uint64_t)(uint32_t)pa[i] << 32 | (uint32_t)pb[i];
            uint64_t h = hash(k) & mask;
            while (entries[h].key != kEmpty && entries[h].key != k)
                h = (h + 1) & mask;
            entries[h] = Entry{k, pr[i], 0};
        }
    }

    // rank or -1
    inline int32_t find(uint64_t k) const {
        uint64_t h = hash(k) & mask;
        for (;;) {
            const Entry& e = entries[h];
            if (e.key == k) return e.val;
            if (e.key == kEmpty) return -1;
            h = (h + 1) & mask;
        }
    }
};

// Per-thread word -> token-ids memo (the reference recomputes BPE for every
// occurrence of every word; natural text is Zipf-distributed, so a word
// cache removes the vast majority of merge-loop work).
struct WordCache {
    struct Entry {
        uint64_t hash;
        uint64_t key_off;
        uint32_t key_len;
        uint32_t ids_off;
        uint32_t ids_len;
    };
    // open-addressing slots: 0 = empty, else entry_index + 1
    std::vector<uint32_t> slots;
    uint64_t mask = 0;
    std::vector<uint8_t> key_arena;
    std::vector<int32_t> ids_arena;
    std::vector<Entry> entries;

    void grow() {
        size_t cap = slots.empty() ? 4096 : slots.size() * 2;
        std::vector<uint32_t> ns(cap, 0);
        uint64_t m = cap - 1;
        for (uint32_t ei = 0; ei < entries.size(); ++ei) {
            uint64_t h = entries[ei].hash & m;
            while (ns[h]) h = (h + 1) & m;
            ns[h] = ei + 1;
        }
        slots.swap(ns);
        mask = m;
    }

    // returns entry index or -1
    int64_t find(uint64_t hash, const uint8_t* key, int64_t len) const {
        if (slots.empty()) return -1;
        uint64_t h = hash & mask;
        while (uint32_t s = slots[h]) {
            const Entry& e = entries[s - 1];
            if (e.hash == hash && e.key_len == (uint32_t)len &&
                std::memcmp(key_arena.data() + e.key_off, key, len) == 0)
                return s - 1;
            h = (h + 1) & mask;
        }
        return -1;
    }

    void insert(uint64_t hash, const uint8_t* key, int64_t len,
                const int32_t* ids, int64_t n_ids) {
        if (entries.size() * 2 + 2 >= slots.size()) grow();
        Entry e;
        e.hash = hash;
        e.key_off = key_arena.size();
        e.key_len = (uint32_t)len;
        e.ids_off = (uint32_t)ids_arena.size();
        e.ids_len = (uint32_t)n_ids;
        key_arena.insert(key_arena.end(), key, key + len);
        ids_arena.insert(ids_arena.end(), ids, ids + n_ids);
        // pad to a 4-id boundary so 16-byte copy_ids_wide reads stay
        // inside the arena
        ids_arena.resize((ids_arena.size() + 3) & ~(size_t)3, 0);
        uint64_t h = hash & mask;
        while (slots[h]) h = (h + 1) & mask;
        slots[h] = (uint32_t)entries.size() + 1;
        entries.push_back(e);
    }
};

// Upper bound on worker threads (per-thread caches are lazily sized, so a
// high cap costs nothing on small machines; TPU pod hosts have 100+ vCPUs)
constexpr int kMaxThreads = 96;
constexpr int64_t kMaxCachedWord = 256;

// Short-word cache: GPT-2 pre-split words are Zipf-distributed and nearly
// all <= 16 bytes (leading space included), so the common hit is a single
// 24-byte-slot probe — key bytes inline as two zero-padded u64s, ids in an
// arena.  len == 0 marks an empty slot (a real key has len >= 1).
constexpr int64_t kMaxShortWord = 16;

// Direct-mapped single-token front cache for words <= 8 bytes: the Zipf
// head of natural text is almost entirely short whole-word-token words,
// so the common probe collapses to one 16-byte slot load and one compare.
// A zero-padded <=8-byte word is uniquely identified by its k0 (text
// never contains NUL), an entry is immutable once written (a word's ids
// never change within a ctx), and slots fill first-come — in Zipf order
// the head words arrive first and keep their slots.  Purely an
// accelerator view of the main caches: a miss falls through to them, so
// exactness never depends on hit rate.
struct FrontCache {
    // cnt == 1: ids holds one full int32 id.  cnt == 2: two u16 ids
    // packed (id0 | id1 << 16) — 2-token tail words under a <64K vocab
    // are ~10% of short-word traffic in steady state (measured round
    // 5) and previously missed the front EVERY pass (only single-token
    // words were representable), re-paying the shared-table walk.
    struct alignas(16) Slot {
        uint64_t k0;     // key bytes, zero-padded
        uint32_t ids;
        uint16_t len;    // 0 = empty; disambiguates NUL-padded keys
        uint16_t cnt;    // 1 or 2
    };
    // 2-WAY set-associative: hash selects an aligned 32-byte PAIR of
    // slots, probed sequentially, inserted first-empty.  The round-5
    // miss attribution showed ~26K/pass of the steady-state misses
    // were direct-map collision LOSERS (24K distinct short words over
    // 32K slots, first-come-wins forever); two ways cut the loser set
    // to 3-deep collisions only.  Probe cost on the common slot-0 hit
    // is unchanged; the way-1 check runs only after a way-0 miss and
    // stays within the same cache-line pair.
    static constexpr uint64_t kBits = 15;  // 32K pairs = 64K slots = 1 MB
    std::vector<Slot> slots;
    static inline uint64_t hash(uint64_t k0) {
        return (k0 * 0x9E3779B97F4A7C15ull) >> (64 - kBits);
    }
    static inline int read_slot(const Slot& s, int32_t* out) {
        if (s.cnt == 1) {
            out[0] = (int32_t)s.ids;
            return 1;
        }
        out[0] = (int32_t)(s.ids & 0xFFFF);
        out[1] = (int32_t)(s.ids >> 16);
        return 2;
    }
    // returns token count (1 or 2) on hit, 0 on miss
    inline int lookup1(uint64_t k0, uint32_t len, int32_t* out) const {
        if (slots.empty()) return 0;
        const Slot* p = &slots[2 * hash(k0)];
        if (p[0].k0 == k0 && p[0].len == (uint16_t)len)
            return read_slot(p[0], out);
        if (p[1].k0 == k0 && p[1].len == (uint16_t)len)
            return read_slot(p[1], out);
        return 0;
    }
    inline Slot* insert_slot(uint64_t k0) {
        if (slots.empty()) slots.resize((size_t)2 << kBits);
        Slot* p = &slots[2 * hash(k0)];
        if (!p[0].len) return p;
        if (!p[1].len) return p + 1;
        return nullptr;
    }
    inline void insert1(uint64_t k0, uint32_t len, int32_t id) {
        Slot* s = insert_slot(k0);
        if (s) {
            s->k0 = k0;
            s->ids = (uint32_t)id;
            s->cnt = 1;
            s->len = (uint16_t)len;  // len last: publishes the entry
        }
    }
    // 2-token insert; only representable when both ids fit u16
    inline void insert2(uint64_t k0, uint32_t len, int32_t id0,
                        int32_t id1) {
        if ((uint32_t)id0 >= 0x10000u || (uint32_t)id1 >= 0x10000u)
            return;
        Slot* s = insert_slot(k0);
        if (s) {
            s->k0 = k0;
            s->ids = (uint32_t)id0 | ((uint32_t)id1 << 16);
            s->cnt = 2;
            s->len = (uint16_t)len;
        }
    }
};

// 2-way front cache for 9-16-byte words (full (k0, k1) key): same
// collision-loser fix as FrontCache, one size up.  ~9% of steady-state
// word traffic is 9-16 bytes (measured round 5) and previously always
// paid the multi-MB shared-table walk; most such words are <= 2 tokens
// under a real vocab, so the packed-u16 id form covers them.
struct Front16 {
    struct alignas(32) Slot {
        uint64_t k0;
        uint64_t k1;
        uint32_t ids;
        uint16_t len;  // 0 = empty
        uint16_t cnt;  // 1 or 2
        uint64_t _pad;
    };
    static constexpr uint64_t kBits = 14;  // 16K pairs = 32K slots = 1 MB
    std::vector<Slot> slots;
    static inline uint64_t hash(uint64_t hv) { return hv >> (64 - kBits); }
    inline int lookup(uint64_t k0, uint64_t k1, uint64_t hv, uint32_t len,
                      int32_t* out) const {
        if (slots.empty()) return 0;
        const Slot* p = &slots[2 * hash(hv)];
        const Slot& s = (p[0].k0 == k0 && p[0].k1 == k1 &&
                         p[0].len == (uint16_t)len)
                            ? p[0]
                            : p[1];
        if (s.k0 != k0 || s.k1 != k1 || s.len != (uint16_t)len) return 0;
        if (s.cnt == 1) {
            out[0] = (int32_t)s.ids;
            return 1;
        }
        out[0] = (int32_t)(s.ids & 0xFFFF);
        out[1] = (int32_t)(s.ids >> 16);
        return 2;
    }
    inline void insert(uint64_t k0, uint64_t k1, uint64_t hv, uint32_t len,
                       const int32_t* ids, int64_t n) {
        if (n < 1 || n > 2) return;
        if (n == 2 &&
            ((uint32_t)ids[0] >= 0x10000u || (uint32_t)ids[1] >= 0x10000u))
            return;
        if (slots.empty()) slots.resize((size_t)2 << kBits);
        Slot* p = &slots[2 * hash(hv)];
        Slot* s = !p[0].len ? p : (!p[1].len ? p + 1 : nullptr);
        if (!s) return;
        s->k0 = k0;
        s->k1 = k1;
        s->ids = n == 1 ? (uint32_t)ids[0]
                        : ((uint32_t)ids[0] | ((uint32_t)ids[1] << 16));
        s->cnt = (uint16_t)n;
        s->len = (uint16_t)len;  // publishes
    }
};

struct ShortCache {
    // 32-byte slots: a 24-byte slot straddles a cache line for every
    // third index, making warm-probe cost depend on allocation luck —
    // the padding buys one-line probes always (tables stay L2-resident)
    struct alignas(32) Slot {
        uint64_t k0;
        uint64_t k1;
        uint32_t ids_off;
        uint8_t ids_len;
        uint8_t len;
        uint16_t _pad;
    };
    std::vector<Slot> slots;
    uint64_t mask = 0;
    size_t count = 0;
    std::vector<int32_t> ids_arena;
    // per-thread accelerator for <=8-byte single-token words (the owning
    // thread is the only prober/inserter, so no synchronization)
    FrontCache front;
    Front16 front16;  // 9-16-byte words, <= 2 tokens

    static inline uint64_t mix(uint64_t k0, uint64_t k1, uint64_t len) {
        uint64_t h = k0 ^ (k1 * 0xFF51AFD7ED558CCDull) ^
                     (len * 0x9E3779B97F4A7C15ull);
        h *= 0xBF58476D1CE4E5B9ull;
        h ^= h >> 31;
        return h;
    }

    void grow() {
        size_t cap = slots.empty() ? 8192 : slots.size() * 2;
        std::vector<Slot> ns(cap);
        uint64_t m = cap - 1;
        for (const Slot& s : slots) {
            if (!s.len) continue;
            uint64_t h = mix(s.k0, s.k1, s.len) & m;
            while (ns[h].len) h = (h + 1) & m;
            ns[h] = s;
        }
        slots.swap(ns);
        mask = m;
    }

    // returns ids count on hit (ids copied to out), -1 on miss.  Slots
    // with ids_len == 1 store the id itself in ids_off (no arena load).
    inline int64_t lookup(uint64_t k0, uint64_t k1, uint8_t len,
                          int32_t* out) const {
        uint64_t h = mix(k0, k1, len) & mask;
        for (;;) {
            const Slot& s = slots[h];
            if (!s.len) return -1;
            if (s.k0 == k0 && s.k1 == k1 && s.len == len) {
                if (s.ids_len == 1) {
                    out[0] = (int32_t)s.ids_off;
                } else {
                    std::memcpy(out, ids_arena.data() + s.ids_off,
                                (size_t)s.ids_len * sizeof(int32_t));
                }
                return s.ids_len;
            }
            h = (h + 1) & mask;
        }
    }

    inline void insert(uint64_t k0, uint64_t k1, uint8_t len,
                       const int32_t* ids, int64_t n_ids) {
        if ((count + 1) * 2 >= slots.size()) grow();
        uint64_t h = mix(k0, k1, len) & mask;
        while (slots[h].len) h = (h + 1) & mask;
        Slot& s = slots[h];
        s.k0 = k0;
        s.k1 = k1;
        s.len = len;
        s.ids_len = (uint8_t)n_ids;
        if (n_ids == 1) {
            s.ids_off = (uint32_t)ids[0];
        } else {
            s.ids_off = (uint32_t)ids_arena.size();
            ids_arena.insert(ids_arena.end(), ids, ids + n_ids);
            // pad to a 4-id boundary for copy_ids_wide (see above)
            ids_arena.resize((ids_arena.size() + 3) & ~(size_t)3, 0);
        }
        ++count;
    }
};

struct Ctx {
    RankTable ranks;
    std::vector<int32_t> rank_new;  // rank -> minted id (-1 gaps)
    int32_t byte_token[256];
    // GPT-2 classes per codepoint: 0=other,1=ws,2=letter,3=number
    const uint8_t* cls_table;  // borrowed; caller keeps alive
    int64_t cls_size;
    uint8_t ascii_cls[128];  // fast path for ASCII bytes
    // true when ascii_cls matches the canonical GPT-2 ASCII classes, so
    // the SIMD run scanner's range checks are exact (validated at init)
    bool simd_ascii;
    WordCache caches[kMaxThreads];
    ShortCache short_caches[kMaxThreads];
    // Shared caches, read-only during batch encode; filled between batches
    // by ctok_cache_insert_batch (typically with device-computed encodes of
    // collected miss words).
    WordCache shared_long;
    ShortCache shared_short;
    // Direct-mapped single-token accelerator over the shared tables
    // (round 4): warm-cache loads and device-fill harvests insert the
    // <=8-byte single-token head here, so the hot-word probe is one
    // aligned 16-byte slot instead of a random walk through the multi-MB
    // shared_short.  Written only under work_mu (insert paths), read
    // only under work_mu (encodes) — same discipline as the tables it
    // accelerates; misses fall through, so exactness never depends on it.
    FrontCache shared_front;
    Front16 shared_front16;
    // Scratch reused by the Python-extension batch entry points (ids at
    // byte offsets, per-text counts/offsets).  call_mu serializes those
    // calls; it is only ever locked with the GIL released, so lock order
    // (call_mu then GIL) can never deadlock against a GIL holder.
    std::mutex call_mu;
    Arena<int32_t> out_arena;
    Arena<int32_t> counts_arena;
    Arena<int64_t> offsets_arena;
    // Serializes every cache-touching operation (encodes mutate their
    // per-thread caches and read the shared ones; cache_insert_batch
    // rehashes the shared ones), so concurrent Python threads — e.g. a
    // background device-fill harvest landing while another thread
    // encodes — can never interleave a rehash with a probe.  Never held
    // while (re)acquiring the GIL.
    std::mutex work_mu;
    // Guards the SHARED caches alone, so the miss scan (which probes only
    // them) can run on the background fill thread concurrently with a
    // host encode — the scan never sits on the serving critical path.
    // Lock order: work_mu before shared_mu; nothing takes them reversed.
    std::mutex shared_mu;
};

inline uint64_t fnv1a(const uint8_t* p, int64_t n) {
    uint64_t h = 1469598103934665603ull;
    for (int64_t i = 0; i < n; ++i) {
        h ^= p[i];
        h *= 1099511628211ull;
    }
    return h;
}

inline PairKey key(int32_t a, int32_t b) {
    return PairKey{(uint64_t)(uint32_t)a << 32 | (uint32_t)b};
}

// ---------------------------------------------------------------------------
// Tiny-copy helpers.  A variable-length std::memcpy of 4-32 bytes pays the
// libc dispatch cost (~20 ns measured on the cache-hit path — larger than
// the probe itself); fixed 16-byte chunk stores cut the warm per-word cost
// ~1.8x.  Safety contract: wide copies may write up to 3 ids past dst+k and
// read up to 3 ids past src+k, so callers gate on the destination bound and
// the arenas are padded to 4-id multiples on insert (pad4()).
// ---------------------------------------------------------------------------
static const uint64_t kLenMask8[9] = {
    0,
    0xFFull,
    0xFFFFull,
    0xFFFFFFull,
    0xFFFFFFFFull,
    0xFFFFFFFFFFull,
    0xFFFFFFFFFFFFull,
    0xFFFFFFFFFFFFFFull,
    ~0ull,
};

// Zero-padded 16-byte inline key as two u64s.  The wide variant reads 16
// bytes from p (caller guarantees readability; see encode_word's bound
// check); the safe variant stages through a zeroed local buffer.
inline void load_key16(const uint8_t* p, int64_t wlen, uint64_t* k0,
                       uint64_t* k1) {
    uint64_t a, b;
    std::memcpy(&a, p, 8);      // one unaligned load
    std::memcpy(&b, p + 8, 8);  // one unaligned load
    if (wlen <= 8) {
        *k0 = a & kLenMask8[wlen];
        *k1 = 0;
    } else {
        *k0 = a;
        *k1 = b & kLenMask8[wlen - 8];
    }
}

inline void load_key16_safe(const uint8_t* p, int64_t wlen, uint64_t* k0,
                            uint64_t* k1) {
    uint8_t buf[16] = {0};
    std::memcpy(buf, p, (size_t)wlen);
    std::memcpy(k0, buf, 8);
    std::memcpy(k1, buf + 8, 8);
}

// Copy k ids in 16-byte chunks; writes ceil4(k) ids (caller checked room,
// arenas padded so the read side is always safe).
inline void copy_ids_wide(int32_t* dst, const int32_t* src, uint32_t k) {
#ifdef CTOK_SSE2
    for (uint32_t i = 0; i < k; i += 4)
        _mm_storeu_si128((__m128i*)(dst + i),
                         _mm_loadu_si128((const __m128i*)(src + i)));
#else
    std::memcpy(dst, src, (size_t)k * sizeof(int32_t));
#endif
}

inline int cls_of(const Ctx* c, uint32_t cp) {
    if ((int64_t)cp >= c->cls_size) return 0;
    return c->cls_table[cp];
}

constexpr int CL_OTHER = 0, CL_WS = 1, CL_LETTER = 2, CL_NUMBER = 3, CL_NONE = 4;

#ifdef CTOK_SSE2
// 16-bit mask of positions where an ASCII class run stops: the byte is
// non-ASCII or its class != run_cls.  Exact for the canonical GPT-2 ASCII
// classes (ws = 0x09-0x0D + 0x20, letters A-Za-z, digits 0-9); callers
// gate on Ctx::simd_ascii.
inline uint32_t run_stop_mask16(const uint8_t* p, int run_cls) {
    __m128i v = _mm_loadu_si128((const __m128i*)p);
    __m128i zero = _mm_setzero_si128();
    __m128i ascii = _mm_cmpgt_epi8(v, _mm_set1_epi8(-1));  // 0x00-0x7F
    __m128i eq;
    if (run_cls == CL_LETTER) {
        __m128i lower = _mm_or_si128(v, _mm_set1_epi8(0x20));
        __m128i t = _mm_sub_epi8(lower, _mm_set1_epi8('a'));
        eq = _mm_cmpeq_epi8(_mm_subs_epu8(t, _mm_set1_epi8(25)), zero);
    } else if (run_cls == CL_NUMBER) {
        __m128i t = _mm_sub_epi8(v, _mm_set1_epi8('0'));
        eq = _mm_cmpeq_epi8(_mm_subs_epu8(t, _mm_set1_epi8(9)), zero);
    } else if (run_cls == CL_WS) {
        __m128i t = _mm_sub_epi8(v, _mm_set1_epi8(9));
        __m128i r = _mm_cmpeq_epi8(_mm_subs_epu8(t, _mm_set1_epi8(4)), zero);
        eq = _mm_or_si128(r, _mm_cmpeq_epi8(v, _mm_set1_epi8(' ')));
    } else {  // CL_OTHER: ASCII and none of the above
        __m128i lower = _mm_or_si128(v, _mm_set1_epi8(0x20));
        __m128i tl = _mm_sub_epi8(lower, _mm_set1_epi8('a'));
        __m128i letter =
            _mm_cmpeq_epi8(_mm_subs_epu8(tl, _mm_set1_epi8(25)), zero);
        __m128i tn = _mm_sub_epi8(v, _mm_set1_epi8('0'));
        __m128i number =
            _mm_cmpeq_epi8(_mm_subs_epu8(tn, _mm_set1_epi8(9)), zero);
        __m128i tw = _mm_sub_epi8(v, _mm_set1_epi8(9));
        __m128i ws =
            _mm_or_si128(_mm_cmpeq_epi8(_mm_subs_epu8(tw, _mm_set1_epi8(4)), zero),
                         _mm_cmpeq_epi8(v, _mm_set1_epi8(' ')));
        eq = _mm_andnot_si128(_mm_or_si128(_mm_or_si128(letter, number), ws),
                              ascii);
    }
    __m128i cont = _mm_and_si128(eq, ascii);
    return (~(uint32_t)_mm_movemask_epi8(cont)) & 0xFFFFu;
}
#endif

// Decode the codepoint whose lead byte is at data[i]; returns byte length.
inline int decode_cp(const uint8_t* data, int64_t n, int64_t i, uint32_t* cp) {
    uint8_t b0 = data[i];
    if (b0 < 0x80) { *cp = b0; return 1; }
    if (b0 < 0xE0) {
        *cp = ((uint32_t)(b0 & 0x1F) << 6) | (i + 1 < n ? data[i + 1] & 0x3F : 0);
        return 2;
    }
    if (b0 < 0xF0) {
        *cp = ((uint32_t)(b0 & 0x0F) << 12) |
              ((i + 1 < n ? (uint32_t)(data[i + 1] & 0x3F) : 0u) << 6) |
              (i + 2 < n ? data[i + 2] & 0x3F : 0);
        return 3;
    }
    *cp = ((uint32_t)(b0 & 0x07) << 18) |
          ((i + 1 < n ? (uint32_t)(data[i + 1] & 0x3F) : 0u) << 12) |
          ((i + 2 < n ? (uint32_t)(data[i + 2] & 0x3F) : 0u) << 6) |
          (i + 3 < n ? data[i + 3] & 0x3F : 0);
    return 4;
}

// Greedy lowest-rank merge loop on one word's token vector (bpe.rs:104-153).
//
// Identical selection semantics to the reference (leftmost occurrence of
// the lowest-rank pair each iteration — strict `<` keeps the leftmost),
// but the pair ranks are maintained incrementally: a merge at i only
// changes pairs (i-1,i) and (i,i+1), so each iteration costs an
// L1-resident min-scan plus two hash probes instead of a fresh probe per
// adjacent pair.  The initial scan prefetches every probed rank-table
// line first — on a GPT-2-scale table (multi-MB, random access) the
// memory-level parallelism is what the cold path is bound by.
inline void merge_word(const Ctx* c, std::vector<int32_t>& toks) {
    size_t n = toks.size();
    if (n < 2) return;
    constexpr int32_t kNoRank = INT32_MAX;
    int32_t rstack[96];
    uint64_t hstack[96];
    std::vector<int32_t> rheap;
    std::vector<uint64_t> hheap;
    int32_t* r = rstack;
    uint64_t* hs = hstack;
    if (n - 1 > 96) {
        rheap.resize(n - 1);
        hheap.resize(n - 1);
        r = rheap.data();
        hs = hheap.data();
    }
    const RankTable& rt = c->ranks;
    size_t m = n - 1;  // live pair count
    for (size_t i = 0; i < m; ++i) {
        uint64_t k = key(toks[i], toks[i + 1]).v;
        hs[i] = k;
        __builtin_prefetch(&rt.entries[RankTable::hash(k) & rt.mask], 0, 1);
    }
    for (size_t i = 0; i < m; ++i) {
        int32_t v = rt.find(hs[i]);
        r[i] = v < 0 ? kNoRank : v;
    }
    for (;;) {
        int32_t best = kNoRank;
        size_t bi = 0;
        for (size_t i = 0; i < m; ++i)
            if (r[i] < best) {
                best = r[i];
                bi = i;
            }
        if (best == kNoRank) break;
        toks[bi] = c->rank_new[best];
        toks.erase(toks.begin() + bi + 1);
        std::memmove(r + bi, r + bi + 1, (m - bi - 1) * sizeof(int32_t));
        --m;
        if (m == 0) break;
        uint64_t ka = 0, kb = 0;
        bool hasa = bi > 0, hasb = bi < m;
        if (hasa) {
            ka = key(toks[bi - 1], toks[bi]).v;
            __builtin_prefetch(&rt.entries[RankTable::hash(ka) & rt.mask], 0,
                               1);
        }
        if (hasb) {
            kb = key(toks[bi], toks[bi + 1]).v;
            __builtin_prefetch(&rt.entries[RankTable::hash(kb) & rt.mask], 0,
                               1);
        }
        if (hasa) {
            int32_t v = rt.find(ka);
            r[bi - 1] = v < 0 ? kNoRank : v;
        }
        if (hasb) {
            int32_t v = rt.find(kb);
            r[bi] = v < 0 ? kNoRank : v;
        }
    }
}

// class of char at data[i]; sets *clen to its UTF-8 length
inline int cls_at(const Ctx* c, const uint8_t* data, int64_t n, int64_t i,
                  int* clen) {
    uint8_t b = data[i];
    if (b < 0x80) {
        *clen = 1;
        return c->ascii_cls[b];
    }
    uint32_t cp;
    *clen = decode_cp(data, n, i, &cp);
    return cls_of(c, cp);
}

// Extend a class run: first position >= end whose char class differs from
// run_cls.  SIMD sweeps 16 ASCII bytes per step; non-ASCII chars and the
// tail fall back to the scalar table walk.
inline int64_t extend_run(const Ctx* c, const uint8_t* data, int64_t n,
                          int64_t end, int run_cls) {
    for (;;) {
#ifdef CTOK_SSE2
        if (c->simd_ascii) {
            while (n - end >= 16) {
                uint32_t stop = run_stop_mask16(data + end, run_cls);
                if (stop) {
                    end += (int)__builtin_ctz(stop);
                    break;
                }
                end += 16;
            }
        }
#endif
        if (end >= n) return end;
        int lr;
        if (cls_at(c, data, n, end, &lr) != run_cls) return end;
        end += lr;
    }
}

// Encode one word's bytes into out; returns count.  Words <= 8 bytes hit
// the inline-key ShortCache (single 16-byte-slot probe); longer cacheable
// words use the arena-backed WordCache.  ``n`` is the readable extent of
// ``data`` (wide key loads read 8 bytes); ``room`` is the id capacity left
// at ``out`` (wide copies write in 4-id chunks).
inline int64_t encode_word(const Ctx* c, WordCache* cache, ShortCache* sc,
                           const uint8_t* data, int64_t start, int64_t end,
                           int64_t n, int32_t* out, int64_t room,
                           std::vector<int32_t>& scratch) {
    int64_t wlen = end - start;
    uint64_t k0 = 0, k1 = 0;
    uint64_t h = 0;
    bool is_short = sc && wlen > 0 && wlen <= kMaxShortWord;
    if (is_short) {
        if (start + 16 <= n)
            load_key16(data + start, wlen, &k0, &k1);
        else
            load_key16_safe(data + start, wlen, &k0, &k1);
        if (wlen <= 8) {
            int fc = c->shared_front.lookup1(k0, (uint32_t)wlen, out);
            if (fc) return fc;
        }
        uint64_t hv = ShortCache::mix(k0, k1, (uint64_t)wlen);
        for (int which = 0; which < 2; ++which) {
            const ShortCache* s = which == 0 ? &c->shared_short : sc;
            if (s->slots.empty()) continue;
            uint64_t hh = hv & s->mask;
            for (;;) {
                const ShortCache::Slot& sl = s->slots[hh];
                if (!sl.len) break;
                if (sl.k0 == k0 && sl.k1 == k1 && sl.len == (uint8_t)wlen) {
                    uint32_t cnt = sl.ids_len;
                    if (cnt == 1) {
                        out[0] = (int32_t)sl.ids_off;
                        return 1;
                    }
                    const int32_t* src = s->ids_arena.data() + sl.ids_off;
                    if ((int64_t)((cnt + 3u) & ~3u) <= room)
                        copy_ids_wide(out, src, cnt);
                    else
                        std::memcpy(out, src, (size_t)cnt * sizeof(int32_t));
                    return cnt;
                }
                hh = (hh + 1) & s->mask;
            }
        }
    } else if (cache && wlen <= kMaxCachedWord) {
        h = fnv1a(data + start, wlen);
        for (int which = 0; which < 2; ++which) {
            const WordCache* wc = which == 0 ? &c->shared_long : cache;
            int64_t ei = wc->find(h, data + start, wlen);
            if (ei >= 0) {
                const WordCache::Entry& e = wc->entries[ei];
                const int32_t* src = wc->ids_arena.data() + e.ids_off;
                if ((int64_t)((e.ids_len + 3u) & ~3u) <= room)
                    copy_ids_wide(out, src, e.ids_len);
                else
                    std::memcpy(out, src, e.ids_len * sizeof(int32_t));
                return e.ids_len;
            }
        }
    }
    scratch.clear();
    for (int64_t k = start; k < end; ++k) {
        int32_t t = c->byte_token[data[k]];
        if (t >= 0) scratch.push_back(t);
    }
    if (!scratch.empty()) merge_word(c, scratch);
    for (size_t i = 0; i < scratch.size(); ++i) out[i] = scratch[i];
    if (is_short) {
        sc->insert(k0, k1, (uint8_t)wlen, scratch.data(),
                   (int64_t)scratch.size());
    } else if (cache && wlen <= kMaxCachedWord) {
        cache->insert(h, data + start, wlen, scratch.data(),
                      (int64_t)scratch.size());
    }
    return (int64_t)scratch.size();
}

// encode_word's short-word body with the key/hash precomputed by the
// pipelined scanner (which has already prefetched both cache slots).
inline int64_t encode_word_short_keyed(const Ctx* c, ShortCache* sc,
                                       const uint8_t* data, int64_t start,
                                       int64_t end, uint64_t k0, uint64_t k1,
                                       uint64_t hv, int32_t* out,
                                       int64_t room,
                                       std::vector<int32_t>& scratch) {
    int64_t wlen = end - start;
    bool frontable = wlen <= 8;  // => k1 == 0; key is (k0, len)
    if (frontable) {
        int fc = sc->front.lookup1(k0, (uint32_t)wlen, out);
        if (fc) return fc;
        fc = c->shared_front.lookup1(k0, (uint32_t)wlen, out);
        if (fc) {
            // promote into the per-thread front: warm-started words
            // live in the SHARED front (bulk load), and without this
            // promotion every later encounter re-pays the two-probe
            // path — measured as the round-4 steady-state regression
            // once the warm-cache artifact landed
            if (fc == 1)
                sc->front.insert1(k0, (uint32_t)wlen, out[0]);
            else
                sc->front.insert2(k0, (uint32_t)wlen, out[0], out[1]);
            return fc;
        }
    } else {
        // 9-16-byte words: the 2-way (k0, k1)-keyed front
        int fc = sc->front16.lookup(k0, k1, hv, (uint32_t)wlen, out);
        if (fc) return fc;
        fc = c->shared_front16.lookup(k0, k1, hv, (uint32_t)wlen, out);
        if (fc) {
            sc->front16.insert(k0, k1, hv, (uint32_t)wlen, out, fc);
            return fc;
        }
    }
    for (int which = 0; which < 2; ++which) {
        const ShortCache* s = which == 0 ? &c->shared_short : sc;
        if (s->slots.empty()) continue;
        uint64_t hh = hv & s->mask;
        for (;;) {
            const ShortCache::Slot& sl = s->slots[hh];
            if (!sl.len) break;
            if (sl.k0 == k0 && sl.k1 == k1 && sl.len == (uint8_t)wlen) {
                uint32_t cnt = sl.ids_len;
                if (cnt == 1) {
                    out[0] = (int32_t)sl.ids_off;
                    if (frontable) sc->front.insert1(k0, (uint32_t)wlen, out[0]);
                    return 1;
                }
                const int32_t* src = s->ids_arena.data() + sl.ids_off;
                if ((int64_t)((cnt + 3u) & ~3u) <= room)
                    copy_ids_wide(out, src, cnt);
                else
                    std::memcpy(out, src, (size_t)cnt * sizeof(int32_t));
                if (frontable && cnt == 2)
                    sc->front.insert2(k0, (uint32_t)wlen, src[0], src[1]);
                else if (!frontable && cnt <= 2)
                    sc->front16.insert(k0, k1, hv, (uint32_t)wlen, src,
                                       (int64_t)cnt);
                return cnt;
            }
            hh = (hh + 1) & s->mask;
        }
    }
    scratch.clear();
    for (int64_t k = start; k < end; ++k) {
        int32_t t = c->byte_token[data[k]];
        if (t >= 0) scratch.push_back(t);
    }
    if (!scratch.empty()) merge_word(c, scratch);
    for (size_t i = 0; i < scratch.size(); ++i) out[i] = scratch[i];
    sc->insert(k0, k1, (uint8_t)wlen, scratch.data(),
               (int64_t)scratch.size());
    if (frontable && scratch.size() == 1)
        sc->front.insert1(k0, (uint32_t)wlen, scratch[0]);
    else if (frontable && scratch.size() == 2)
        sc->front.insert2(k0, (uint32_t)wlen, scratch[0], scratch[1]);
    else if (!frontable && scratch.size() <= 2 && !scratch.empty())
        sc->front16.insert(k0, k1, hv, (uint32_t)wlen, scratch.data(),
                           (int64_t)scratch.size());
    return (int64_t)scratch.size();
}

// End of the contraction match ('s 't 'm 'd 're 've 'll) starting at i,
// or -1 — the one rule shared verbatim by the scalar walk and the AVX-512
// bitmask walk, so it lives in exactly one place.
inline int64_t match_contraction(const uint8_t* data, int64_t n, int64_t i) {
    if (data[i] != '\'' || i + 1 >= n) return -1;
    uint8_t n1 = data[i + 1];
    if (n1 == 's' || n1 == 't' || n1 == 'm' || n1 == 'd') return i + 2;
    if (i + 2 < n) {
        uint8_t n2 = data[i + 2];
        if ((n1 == 'r' && n2 == 'e') || (n1 == 'v' && n2 == 'e') ||
            (n1 == 'l' && n2 == 'l'))
            return i + 3;
    }
    return -1;
}

// End of the GPT-2 simplified match starting at i (contraction / optional
// space-prefix / class-run rules of pretokenizers.rs:8-15).
inline int64_t word_end_at(const Ctx* c, const uint8_t* data, int64_t n,
                           int64_t i) {
    int clen;
    int cur_cls = cls_at(c, data, n, i, &clen);
    int64_t contr = match_contraction(data, n, i);
    if (contr >= 0) return contr;
    int64_t j = i;
    int run_cls = cur_cls;
    if (data[i] == ' ' && i + 1 < n) {
        int l2;
        int c2 = cls_at(c, data, n, i + 1, &l2);
        if (c2 != CL_WS) {
            j = i + 1;
            run_cls = c2;
        }
    }
    int64_t end = (run_cls == CL_WS) ? i : j;
    return extend_run(c, data, n, end, run_cls);
}

#ifdef CTOK_AVX512
// ---------------------------------------------------------------------------
// Whole-text boundary-bitmask scanner (ASCII fast path).
//
// The GPT-2 simplified matches over pure-ASCII text reduce to local rules
// on per-byte classes: a word starts exactly at every class transition,
// EXCEPT that a transition out of an *isolated* ' ' (a 1-char whitespace
// run that is a space) is removed — the space attaches to the following
// run (' ?\p{L}+' etc.), matching word_end_at's space-prefix branch.
// Contractions ('s 't 'm 'd 're 've 'll) are the only non-local rule and
// are handled at walk time when a word starts with a quote (identical
// check to word_end_at).  Texts containing any non-ASCII byte fall back to
// the scalar word_end_at walk, so exactness never depends on this path.
// ---------------------------------------------------------------------------

// Classify one <=64-byte block: per-byte class masks for the canonical
// GPT-2 ASCII classes (gated by Ctx::simd_ascii).  Bytes beyond `valid`
// read as 0 (class OTHER).  Returns the non-ASCII mask.
inline uint64_t classify64(const uint8_t* p, uint64_t valid, uint64_t* ws,
                           uint64_t* sp, uint64_t* b0, uint64_t* b1) {
    __m512i v = _mm512_maskz_loadu_epi8((__mmask64)valid, p);
    uint64_t nonascii = (uint64_t)_mm512_movepi8_mask(v);
    __m512i lower = _mm512_or_si512(v, _mm512_set1_epi8(0x20));
    uint64_t mL = (uint64_t)_mm512_cmple_epu8_mask(
        _mm512_sub_epi8(lower, _mm512_set1_epi8('a')), _mm512_set1_epi8(25));
    uint64_t mN = (uint64_t)_mm512_cmple_epu8_mask(
        _mm512_sub_epi8(v, _mm512_set1_epi8('0')), _mm512_set1_epi8(9));
    uint64_t mW = (uint64_t)_mm512_cmple_epu8_mask(
                      _mm512_sub_epi8(v, _mm512_set1_epi8(9)),
                      _mm512_set1_epi8(4)) |
                  (uint64_t)_mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8(' '));
    mL &= ~nonascii;  // 0xC0|0x20 etc. must not alias into the ranges
    *ws = mW & valid;
    *sp = (uint64_t)_mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8(' ')) & valid;
    // 2-bit class code per byte: WS=01, L=10, N=11, O=00 — a transition is
    // a change in either bit plane
    *b0 = (mW | mN) & valid;
    *b1 = (mL | mN) & valid;
    return nonascii;
}

constexpr int64_t kScanStackBlocks = 40;  // texts <= 2560 B stay on-stack

// Build the word-start bitmask for a pure-ASCII text.  Returns the block
// count, or -1 if a non-ASCII byte was seen (caller uses the scalar walk).
inline int64_t build_bounds(const uint8_t* data, int64_t n, uint64_t* bound,
                            uint64_t* wsv, uint64_t* spv) {
    int64_t nblk = (n + 63) >> 6;
    uint64_t pb0 = 0, pb1 = 0;  // bit63 of the previous block's class planes
    for (int64_t k = 0; k < nblk; ++k) {
        int64_t off = k << 6;
        int64_t m = n - off;
        uint64_t valid = m >= 64 ? ~0ull : ((~0ull) >> (64 - m));
        uint64_t ws, sp, b0, b1;
        if (classify64(data + off, valid, &ws, &sp, &b0, &b1)) return -1;
        bound[k] = (b0 ^ ((b0 << 1) | pb0)) | (b1 ^ ((b1 << 1) | pb1));
        wsv[k] = ws;
        spv[k] = sp;
        pb0 = b0 >> 63;
        pb1 = b1 >> 63;
    }
    // removal pass: drop the boundary right after an isolated space
    uint64_t pws = 0, pisol = 0;
    for (int64_t k = 0; k < nblk; ++k) {
        uint64_t ws = wsv[k];
        uint64_t ws_next = (ws >> 1) | ((k + 1 < nblk ? wsv[k + 1] : 0) << 63);
        uint64_t isol = spv[k] & ~((ws << 1) | pws) & ~ws_next;
        bound[k] &= ~((isol << 1) | pisol);
        pws = ws >> 63;
        pisol = isol >> 63;
    }
    bound[0] |= 1;  // a word always starts at the text head
    return nblk;
}

// First word-start >= from, else n.
inline int64_t next_bound(const uint64_t* bound, int64_t nblk, int64_t from,
                          int64_t n) {
    int64_t k = from >> 6;
    if (k >= nblk) return n;
    uint64_t w = bound[k] & ((~0ull) << (from & 63));
    while (!w) {
        if (++k >= nblk) return n;
        w = bound[k];
    }
    return (k << 6) + __builtin_ctzll(w);
}
#endif  // CTOK_AVX512

// Iterate the GPT-2 simplified matches of one text, calling f(start, end)
// per word.  Uses the SIMD class scan where eligible, the exact scalar
// walk otherwise — the same boundaries the encode path produces.
template <class F>
inline void for_each_word(const Ctx* c, const uint8_t* data, int64_t n,
                          F&& f) {
    if (n <= 0) return;
#ifdef CTOK_AVX512
    if (c->simd_ascii) {
        uint64_t stack_buf[kScanStackBlocks * 3];
        std::vector<uint64_t> heap_buf;
        uint64_t* buf = stack_buf;
        int64_t nblk_cap = (n + 63) >> 6;
        if (nblk_cap > kScanStackBlocks) {
            heap_buf.resize((size_t)nblk_cap * 3);
            buf = heap_buf.data();
        }
        uint64_t* bound = buf;
        int64_t nblk = build_bounds(data, n, bound, buf + nblk_cap,
                                    buf + nblk_cap * 2);
        if (nblk >= 0) {
            int64_t i = 0;
            while (i < n) {
                int64_t end = match_contraction(data, n, i);
                if (end < 0) end = next_bound(bound, nblk, i + 1, n);
                f(i, end);
                i = end;
            }
            return;
        }
    }
#endif
    int64_t i = 0;
    while (i < n) {
        int64_t end = word_end_at(c, data, n, i);
        f(i, end);
        i = end;
    }
}

// Scan [data, data+n) emitting GPT-2 simplified matches; for each word call
// encode_word.  Returns total ids written.
inline int64_t encode_text(const Ctx* c, WordCache* cache, ShortCache* sc,
                           const uint8_t* data,
                           int64_t n, int32_t* out,
                           std::vector<int32_t>& scratch) {
    if (n <= 0) return 0;
    int64_t n_out = 0;
    int64_t i = 0;
#ifdef CTOK_AVX512
    if (c->simd_ascii) {
        uint64_t stack_buf[kScanStackBlocks * 3];
        std::vector<uint64_t> heap_buf;
        uint64_t* buf = stack_buf;
        int64_t nblk_cap = (n + 63) >> 6;
        if (nblk_cap > kScanStackBlocks) {
            heap_buf.resize((size_t)nblk_cap * 3);
            buf = heap_buf.data();
        }
        uint64_t* bound = buf;
        uint64_t* wsv = buf + nblk_cap;
        uint64_t* spv = buf + nblk_cap * 2;
        int64_t nblk = build_bounds(data, n, bound, wsv, spv);
        if (nblk >= 0) {
            // Quote-free texts (the overwhelming majority) take a bulk
            // path: every word start is a set bit in the boundary mask,
            // so one ctz sweep extracts all boundaries up front — no
            // per-word next_bound/match_contraction calls.  Texts with a
            // "'" keep the exact contraction-aware walk.
            int64_t bstack[1024];
            std::vector<int64_t> bheap;
            int64_t* bnd = bstack;
            int64_t nb = -1;
            if (!memchr(data, '\'', (size_t)n)) {
                if (n + 1 > 1024) {
                    bheap.resize((size_t)n + 1);
                    bnd = bheap.data();
                }
                nb = 0;
                for (int64_t k = 0; k < nblk; ++k) {
                    uint64_t w = bound[k];
                    int64_t base = k << 6;
                    while (w) {
                        int64_t pos = base + __builtin_ctzll(w);
                        w &= w - 1;
                        // the <<1 in build_bounds can mark a transition at
                        // position n (end of text) — a word END, never a
                        // word start
                        if (pos < n) bnd[nb++] = pos;
                    }
                }
                bnd[nb] = n;
            }
            // Tight per-word loop.  The table set is L2/L3-resident and
            // words are independent, so out-of-order execution already
            // overlaps probe latencies — the round-3 measurements showed
            // per-word cost is bound by straight-line instruction count,
            // not memory.  The common case (<=8-byte word, front-cache
            // hit) is: one masked load, one multiply-shift hash, one
            // 16-byte slot compare, one id store; mix/hv are only
            // computed on a front miss.
            const FrontCache& front = sc->front;
            auto do_word = [&](int64_t start, int64_t end) {
                int64_t wlen = end - start;
                if (wlen <= 8) {
                    uint64_t k0;
                    if (start + 8 <= n) {
                        std::memcpy(&k0, data + start, 8);
                        k0 &= kLenMask8[wlen];
                    } else {
                        uint64_t k1_unused;
                        load_key16_safe(data + start, wlen, &k0, &k1_unused);
                    }
                    if (!front.slots.empty()) {
                        const FrontCache::Slot* fp =
                            &front.slots[2 * FrontCache::hash(k0)];
                        const FrontCache::Slot& fs =
                            (fp[0].k0 == k0 &&
                             fp[0].len == (uint16_t)wlen)
                                ? fp[0]
                                : fp[1];
                        if (fs.k0 == k0 && fs.len == (uint16_t)wlen) {
#ifdef CTOK_COUNTERS
                            ++g_front_hit;
#endif
                            if (fs.cnt == 1) {
                                out[n_out++] = (int32_t)fs.ids;
                            } else {
                                out[n_out++] = (int32_t)(fs.ids & 0xFFFF);
                                out[n_out++] = (int32_t)(fs.ids >> 16);
                            }
                            return;
                        }
                    }
#ifdef CTOK_COUNTERS
                    ++g_front_miss;
#endif
                    uint64_t hv = ShortCache::mix(k0, 0, (uint64_t)wlen);
                    n_out += encode_word_short_keyed(c, sc, data, start, end,
                                                     k0, 0, hv, out + n_out,
                                                     n - n_out, scratch);
                } else if (wlen <= kMaxShortWord) {
                    uint64_t k0, k1;
                    if (start + 16 <= n)
                        load_key16(data + start, wlen, &k0, &k1);
                    else
                        load_key16_safe(data + start, wlen, &k0, &k1);
                    uint64_t hv = ShortCache::mix(k0, k1, (uint64_t)wlen);
#ifdef CTOK_COUNTERS
                    ++g_keyed;
#endif
                    n_out += encode_word_short_keyed(c, sc, data, start, end,
                                                     k0, k1, hv, out + n_out,
                                                     n - n_out, scratch);
                } else {
                    n_out += encode_word(c, cache, nullptr, data, start, end,
                                         n, out + n_out, n - n_out, scratch);
                }
            };
            if (nb >= 0) {
                // (A software-pipelined slot-pair prefetch over bnd[]
                // was measured here in round 5 and REVERTED: the Zipf
                // head's slots are already cache-resident, so the +4
                // instructions per word cost ~8% with no latency won.)
                for (int64_t j = 0; j < nb; ++j) do_word(bnd[j], bnd[j + 1]);
            } else {
                while (i < n) {
                    int64_t end = match_contraction(data, n, i);
                    if (end < 0) end = next_bound(bound, nblk, i + 1, n);
                    do_word(i, end);
                    i = end;
                }
            }
            return n_out;
        }
    }
#endif
    while (i < n) {
        int64_t end = word_end_at(c, data, n, i);
        n_out += encode_word(c, cache, sc, data, i, end, n, out + n_out,
                             n - n_out, scratch);
        i = end;
    }
    return n_out;
}

// Encode one text read in place from the caller's buffer (no corpus join),
// virtually prefixed with a space when ``pre`` — the ByteLevel
// add_prefix_space semantics.  Only the first match can straddle the
// virtual boundary, so it is staged into a small stack buffer (most first
// words fit the 24-byte stage; a second stage covers up to 271 bytes; a
// first word longer than that falls back to a full prefixed copy in
// ``tmp``).  Everything after the first match is encoded directly from
// ``p``.
inline int64_t encode_text_span(const Ctx* c, WordCache* cache,
                                ShortCache* sc, const uint8_t* p, int64_t n,
                                bool pre, int32_t* out,
                                std::vector<int32_t>& scratch,
                                std::vector<uint8_t>& tmp) {
    if (!pre || n <= 0) return encode_text(c, cache, sc, p, n, out, scratch);
    uint8_t buf[272];
    buf[0] = ' ';
    int64_t st = n < 23 ? n : 23;
    std::memcpy(buf + 1, p, (size_t)st);
    int64_t end = word_end_at(c, buf, st + 1, 0);
    if (end == st + 1 && st < n) {
        int64_t stage = n < 271 ? n : 271;
        std::memcpy(buf + 1 + st, p + st, (size_t)(stage - st));
        end = word_end_at(c, buf, stage + 1, 0);
        if (end == stage + 1 && stage < n) {
            // first word longer than the stage: full prefixed copy (rare)
            tmp.resize((size_t)n + 1);
            tmp[0] = ' ';
            std::memcpy(tmp.data() + 1, p, (size_t)n);
            return encode_text(c, cache, sc, tmp.data(), n + 1, out, scratch);
        }
        st = stage;
    }
    int64_t k =
        encode_word(c, cache, sc, buf, 0, end, st + 1, out, n + 1, scratch);
    int64_t done = end - 1;  // consumed bytes of the real text
    return k + encode_text(c, cache, sc, p + done, n - done, out + k,
                           scratch);
}


// ---------------------------------------------------------------------------
// Native ByteLevel decoder (decoders.rs:94-119 + the cleanup table of
// huggingface/mod.rs:749-769): ids -> per-id raw bytes (precomputed arena)
// -> strict-UTF-8 check -> ASCII replace table -> unicode-whitespace
// split-join.  Rows containing invalid UTF-8 are flagged for the exact
// Python path (from_utf8_lossy replacement semantics), keeping this code
// simple and byte-exact.
// ---------------------------------------------------------------------------
struct DecCtx {
    std::vector<uint8_t> arena;  // padded by 8 slack bytes for wide copies
    std::vector<int64_t> offs;  // n_ids + 1
    std::vector<uint8_t> skip;  // 1 = special token (skippable)
    // packed per-id entry: offset (low 32) | len (bits 32..62) | special
    // (bit 63) — one load instead of two offs[] loads + a skip[] load
    std::vector<uint64_t> ent;
    int64_t n_ids = 0;
    const uint8_t* cls_table = nullptr;  // borrowed; caller keeps alive
    int64_t cls_size = 0;
};

constexpr uint64_t kDecSpecialBit = 1ull << 63;

inline bool all_ascii(const uint8_t* p, int64_t n) {
    int64_t i = 0;
#ifdef CTOK_SSE2
    __m128i acc = _mm_setzero_si128();
    for (; i + 16 <= n; i += 16)
        acc = _mm_or_si128(acc, _mm_loadu_si128((const __m128i*)(p + i)));
    if (_mm_movemask_epi8(acc)) return false;
#endif
    uint8_t tail = 0;
    for (; i < n; ++i) tail |= p[i];
    return tail < 0x80;
}

inline bool utf8_valid(const uint8_t* p, int64_t n) {
    int64_t i = 0;
    while (i < n) {
        uint8_t b = p[i];
        if (b < 0x80) { ++i; continue; }
        int len;
        uint32_t cp, min_cp;
        if ((b & 0xE0) == 0xC0) { len = 2; cp = b & 0x1F; min_cp = 0x80; }
        else if ((b & 0xF0) == 0xE0) { len = 3; cp = b & 0x0F; min_cp = 0x800; }
        else if ((b & 0xF8) == 0xF0) { len = 4; cp = b & 0x07; min_cp = 0x10000; }
        else return false;
        if (i + len > n) return false;
        for (int k = 1; k < len; ++k) {
            if ((p[i + k] & 0xC0) != 0x80) return false;
            cp = (cp << 6) | (p[i + k] & 0x3F);
        }
        if (cp < min_cp || cp > 0x10FFFF || (cp >= 0xD800 && cp <= 0xDFFF))
            return false;
        i += len;
    }
    return true;
}

struct Pat { const char* a; const char* b; };
static const Pat kCleanupTable[] = {
    {" .", "."}, {" ,", ","}, {" !", "!"}, {" ?", "?"}, {" :", ":"},
    {" ;", ";"}, {"\" ", "\""}, {" \"", "\""}, {"' ", "'"}, {" '", "'"},
    {"( ", "("}, {" )", ")"}, {"[ ", "["}, {" ]", "]"}, {" - ", "-"}};
constexpr size_t kNCleanup = sizeof(kCleanupTable) / sizeof(Pat);

// One exact occurrence scan over the row replaces the 15 per-pattern
// memmem sweeps for the (overwhelmingly common) rows where no pattern
// occurs.  ``by_first[b]`` is the bitmask of patterns starting with byte
// b, so non-trigger bytes cost one table load.  Sequential replace
// semantics stay exact: the scan gates only the patterns checked BEFORE
// any replacement fires; once one fires (string changed), the remaining
// patterns run unconditionally.
struct CleanupTrig {
    // first_idx[b] >= 0 iff some pattern starts with byte b; second_mask
    // then resolves the full (2-byte) pattern with one load on the next
    // byte — every table entry is distinct per (first, second) pair, so
    // no inner loop over candidate patterns is needed.  The single 3-byte
    // pattern (" - ") gets a dedicated bit re-checked on the third byte.
    int8_t first_idx[256];
    uint32_t second_mask[kNCleanup][256];  // >= #distinct first bytes
    uint32_t three_byte_bits = 0;
    CleanupTrig() {
        std::memset(first_idx, -1, sizeof(first_idx));
        std::memset(second_mask, 0, sizeof(second_mask));
        int8_t next = 0;
        for (size_t p = 0; p < kNCleanup; ++p) {
            uint8_t f = (uint8_t)kCleanupTable[p].a[0];
            if (first_idx[f] < 0) first_idx[f] = next++;
            second_mask[first_idx[f]][(uint8_t)kCleanupTable[p].a[1]] |=
                1u << p;
            if (kCleanupTable[p].a[2] != 0) three_byte_bits |= 1u << p;
        }
    }
};
static const CleanupTrig kCleanupTrig;

inline uint32_t cleanup_occurrence(const uint8_t* s, size_t n,
                                   bool* needs_wsj) {
    // needs_wsj: whether split_whitespace+join(" ") could change the row —
    // leading/trailing/consecutive whitespace, ASCII ws other than ' ',
    // or any non-ASCII byte (conservative: unicode ws lives there).
    // Replacements only delete interior spaces, so a row that does not
    // need the join before the replace chain cannot need it after.
    uint32_t occ = 0;
    bool wsj = false;
    bool prev_ws = true;  // leading ws counts
    for (size_t i = 0; i < n; ++i) {
        uint8_t b = s[i];
        bool is_sp = b == ' ';
        wsj |= (b >= 0x80) | (b >= 9 && b <= 13) | (is_sp & prev_ws);
        prev_ws = is_sp;
        int8_t fi = kCleanupTrig.first_idx[b];
        if (fi >= 0 && i + 1 < n) {
            uint32_t cand = kCleanupTrig.second_mask[fi][s[i + 1]];
            if (cand & kCleanupTrig.three_byte_bits) {
                uint32_t tb = cand & kCleanupTrig.three_byte_bits;
                while (tb) {
                    int p = __builtin_ctz(tb);
                    tb &= tb - 1;
                    if (!(i + 2 < n &&
                          s[i + 2] == (uint8_t)kCleanupTable[p].a[2]))
                        cand &= ~(1u << p);
                }
            }
            occ |= cand;
        }
    }
    *needs_wsj = wsj | prev_ws;  // trailing ws counts
    return occ;
}

// Sequential replace with the reference's str.replace semantics.  Returns
// false (dst untouched) when the pattern does not occur — the common case
// is one SIMD memmem sweep and no copy at all.
inline bool replace_pass(const uint8_t* base, size_t n,
                         std::vector<uint8_t>& dst, const char* pat,
                         size_t pl, const char* rep, size_t rl) {
    if (pl == 0 || pl > n) return false;
    const uint8_t* hit =
        (const uint8_t*)memmem(base, n, pat, pl);
    if (!hit) return false;
    dst.clear();
    size_t i = 0;
    while (hit) {
        size_t at = (size_t)(hit - base);
        dst.insert(dst.end(), base + i, base + at);
        dst.insert(dst.end(), rep, rep + rl);
        i = at + pl;
        if (i + pl > n) break;
        hit = (const uint8_t*)memmem(base + i, n - i, pat, pl);
    }
    dst.insert(dst.end(), base + i, base + n);
    return true;
}

// whitespace split + single-space join (tokenizer._split_whitespace_join):
// the cls_table's CL_WS class is exactly the whitespace set
inline void ws_split_join(const DecCtx* d, const uint8_t* src, size_t n,
                          std::vector<uint8_t>& dst) {
    dst.clear();
    size_t i = 0;
    bool in_word = false;
    while (i < n) {
        uint8_t b = src[i];
        int len = 1;
        bool is_ws;
        if (b < 0x80) {
            is_ws = (b >= 9 && b <= 13) || b == 32;
        } else {
            uint32_t cp;
            len = decode_cp(src, (int64_t)n, (int64_t)i, &cp);
            is_ws = (int64_t)cp < d->cls_size && d->cls_table[cp] == CL_WS;
        }
        if (is_ws) {
            in_word = false;
        } else {
            if (!in_word) {
                if (!dst.empty()) dst.push_back(' ');
                in_word = true;
            }
            dst.insert(dst.end(), src + i, src + i + len);
        }
        i += (size_t)len;
    }
}

// Decode rows [lo, hi) into outb (back to back) with per-row byte sizes
// in sz; out_flags[r] = 1 marks invalid-UTF-8 rows (empty output).  The
// id gather writes through a slack-padded scratch buffer in unchecked
// 8-byte copies (the arena carries 8 slack bytes past every token).
inline void decode_rows_range(const DecCtx* d, const int32_t* ids_flat,
                              const int64_t* row_offsets, int64_t lo,
                              int64_t hi, int32_t skip_special,
                              int32_t cleanup, std::vector<uint8_t>& outb,
                              std::vector<int64_t>& sz, uint8_t* out_flags) {
    sz.resize((size_t)(hi - lo));
    std::vector<uint8_t> buf_a(1024);
    std::vector<uint8_t> scratch[2];
    const uint8_t* arena = d->arena.data();
    const uint64_t* ent = d->ent.data();
    const uint64_t n_ids = (uint64_t)d->n_ids;
    const uint64_t skip_bit = skip_special ? kDecSpecialBit : 0;
    for (int64_t r = lo; r < hi; ++r) {
        out_flags[r] = 0;
        size_t pos = 0;
        for (int64_t k = row_offsets[r]; k < row_offsets[r + 1]; ++k) {
            uint64_t id = (uint64_t)(int64_t)ids_flat[k];
            if (id >= n_ids) continue;  // unknown / negative: dropped
            uint64_t e = ent[(size_t)id];
            if (e & skip_bit) continue;
            size_t len = (size_t)((e >> 32) & 0x7FFFFFFFu);
            if (pos + len + 8 > buf_a.size())
                buf_a.resize(std::max(buf_a.size() * 2, pos + len + 64));
            const uint8_t* src = arena + (uint32_t)e;
            std::memcpy(buf_a.data() + pos, src, 8);
            if (len > 8)
                std::memcpy(buf_a.data() + pos + 8, src + 8, len - 8);
            pos += len;
        }
        if (!all_ascii(buf_a.data(), (int64_t)pos) &&
            !utf8_valid(buf_a.data(), (int64_t)pos)) {
            out_flags[r] = 1;
            sz[(size_t)(r - lo)] = 0;
            continue;
        }
        const uint8_t* cur = buf_a.data();
        size_t cur_n = pos;
        if (cleanup) {
            bool needs_wsj = false;
            uint32_t occ = cleanup_occurrence(cur, cur_n, &needs_wsj);
            bool fired = false;
            int which = 0;
            for (size_t pi = 0; occ != 0 && pi < kNCleanup; ++pi) {
                if (!fired && !((occ >> pi) & 1)) continue;
                const Pat& rp = kCleanupTable[pi];
                if (replace_pass(cur, cur_n, scratch[which], rp.a,
                                 std::strlen(rp.a), rp.b,
                                 std::strlen(rp.b))) {
                    cur = scratch[which].data();
                    cur_n = scratch[which].size();
                    which ^= 1;
                    fired = true;
                }
            }
            if (needs_wsj || fired) {
                ws_split_join(d, cur, cur_n, scratch[which]);
                cur = scratch[which].data();
                cur_n = scratch[which].size();
            }
        }
        sz[(size_t)(r - lo)] = (int64_t)cur_n;
        outb.insert(outb.end(), cur, cur + cur_n);
    }
}

// Thread fan-out over contiguous row ranges; bufs/sizes are per-thread.
inline int decode_shards(const DecCtx* d, const int32_t* ids_flat,
                         const int64_t* row_offsets, int64_t n_rows,
                         int32_t skip_special, int32_t cleanup,
                         uint8_t* out_flags,
                         std::vector<std::vector<uint8_t>>& bufs,
                         std::vector<std::vector<int64_t>>& sizes) {
    int n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;
    if (n_threads > kMaxThreads) n_threads = kMaxThreads;
    if (n_rows < n_threads * 8) n_threads = 1;
    bufs.resize((size_t)n_threads);
    sizes.resize((size_t)n_threads);
    int64_t total_ids = row_offsets[n_rows];
    auto worker = [&](int tid) {
        int64_t lo = n_rows * tid / n_threads;
        int64_t hi = n_rows * (tid + 1) / n_threads;
        bufs[(size_t)tid].reserve(
            (size_t)((total_ids / (n_rows ? n_rows : 1) + 8) * (hi - lo) *
                     4));
        decode_rows_range(d, ids_flat, row_offsets, lo, hi, skip_special,
                          cleanup, bufs[(size_t)tid], sizes[(size_t)tid],
                          out_flags);
    };
    pool().run(n_threads, worker);
    return n_threads;
}

}  // namespace

extern "C" {

void* ctok_new(int64_t n_pairs, const int32_t* pa, const int32_t* pb,
               const int32_t* pr, const int32_t* rank_new, int64_t n_ranks,
               const int32_t* byte_token, const uint8_t* cls_table,
               int64_t cls_size) {
    Ctx* c = new Ctx();
    c->ranks.build(n_pairs, pa, pb, pr);
    c->rank_new.assign(rank_new, rank_new + n_ranks);
    std::memcpy(c->byte_token, byte_token, 256 * sizeof(int32_t));
    c->cls_table = cls_table;
    c->cls_size = cls_size;
    for (int i = 0; i < 128 && i < cls_size; ++i) c->ascii_cls[i] = cls_table[i];
    c->simd_ascii = cls_size >= 128;
    for (int b = 0; b < 128 && c->simd_ascii; ++b) {
        int expected;
        if ((b >= 9 && b <= 13) || b == 32) expected = CL_WS;
        else if ((b >= 'A' && b <= 'Z') || (b >= 'a' && b <= 'z')) expected = CL_LETTER;
        else if (b >= '0' && b <= '9') expected = CL_NUMBER;
        else expected = CL_OTHER;
        if ((int)c->ascii_cls[b] != expected) c->simd_ascii = false;
    }
    return c;
}

void ctok_free(void* p) { delete (Ctx*)p; }

// Full host encode of one UTF-8 text (already normalized, prefix-space
// already applied).  Writes ids into out (capacity n, one id per input byte
// is an upper bound).  Returns the id count.
int64_t ctok_encode(void* p, const uint8_t* data, int64_t n, int32_t* out) {
    Ctx* c = (Ctx*)p;
    std::lock_guard<std::mutex> lk(c->work_mu);
    std::vector<int32_t> scratch;
    scratch.reserve(64);
    return encode_text(c, &c->caches[0], &c->short_caches[0], data, n, out, scratch);
}

// Batch encode with per-thread word caches.  ``joined`` holds all texts
// back to back; ``offsets[i]..offsets[i+1]`` delimits text i.  Ids for text
// i are written at out + offsets[i] (a text's id count never exceeds its
// byte count); counts go to out_counts.  Caches persist across calls.
void ctok_encode_batch(void* p, const uint8_t* joined, const int64_t* offsets,
                       int64_t n_texts, int32_t* out, int32_t* out_counts,
                       int32_t n_threads) {
    Ctx* c = (Ctx*)p;
    std::lock_guard<std::mutex> lk(c->work_mu);
    if (n_threads < 1) n_threads = 1;
    if (n_threads > kMaxThreads) n_threads = kMaxThreads;
    if (n_texts < n_threads * 4) n_threads = 1;

    auto worker = [&](int tid) {
        std::vector<int32_t> scratch;
        scratch.reserve(64);
        WordCache* cache = &c->caches[tid];
        ShortCache* sc = &c->short_caches[tid];
        // balanced partition by byte volume
        int64_t total = offsets[n_texts];
        int64_t lo_b = total * tid / n_threads;
        int64_t hi_b = shard_hi(total, tid, n_threads);
        for (int64_t i = 0; i < n_texts; ++i) {
            int64_t a = offsets[i];
            if (a < lo_b || a >= hi_b) continue;
            int64_t b = offsets[i + 1];
            out_counts[i] = (int32_t)encode_text(
                c, cache, sc, joined + a, b - a, out + a, scratch);
        }
    };
    pool().run(n_threads, worker);
}

// Compact per-text id regions (written at byte offsets by
// ctok_encode_batch) into one contiguous buffer + result offsets.
void ctok_compact(const int32_t* src, const int64_t* offsets,
                  const int32_t* counts, int64_t n_texts, int32_t* dst,
                  int64_t* dst_offsets) {
    int64_t pos = 0;
    for (int64_t i = 0; i < n_texts; ++i) {
        dst_offsets[i] = pos;
        int64_t cnt = counts[i];
        std::memcpy(dst + pos, src + offsets[i], cnt * sizeof(int32_t));
        pos += cnt;
    }
    dst_offsets[n_texts] = pos;
}

// ---- decoder C ABI ----

void* ctok_decoder_new(const uint8_t* bytes_buf, const int64_t* id_offsets,
                       int64_t n_ids, const uint8_t* special_mask,
                       const uint8_t* cls_table, int64_t cls_size) {
    DecCtx* d = new DecCtx();
    d->n_ids = n_ids;
    d->offs.assign(id_offsets, id_offsets + n_ids + 1);
    d->arena.assign(bytes_buf, bytes_buf + id_offsets[n_ids]);
    d->arena.resize(d->arena.size() + 8, 0);  // wide-copy slack
    d->skip.assign(special_mask, special_mask + n_ids);
    d->cls_table = cls_table;
    d->cls_size = cls_size;
    d->ent.resize((size_t)n_ids);
    for (int64_t i = 0; i < n_ids; ++i) {
        uint64_t off = (uint64_t)id_offsets[i];
        uint64_t len = (uint64_t)(id_offsets[i + 1] - id_offsets[i]);
        d->ent[(size_t)i] = off | (len << 32) |
                            (special_mask[i] ? kDecSpecialBit : 0);
    }
    return d;
}

void ctok_decoder_free(void* p) { delete (DecCtx*)p; }

// Decode rows of ids into out (final UTF-8 bytes, rows delimited by
// out_offsets).  Rows with invalid UTF-8 get out_flags[i] = 1 and empty
// output (caller uses the exact lossy Python path).  Returns total bytes
// written, or -1 if cap would overflow (caller retries with a larger cap).
int64_t ctok_decode_batch(void* p, const int32_t* ids_flat,
                          const int64_t* row_offsets, int64_t n_rows,
                          int32_t skip_special, int32_t cleanup,
                          uint8_t* out, int64_t* out_offsets,
                          uint8_t* out_flags, int64_t cap) {
    DecCtx* d = (DecCtx*)p;
    // contiguous row ranges per thread; each thread builds its own buffer
    // and per-row sizes, then blocks concatenate in order
    std::vector<std::vector<uint8_t>> bufs;
    std::vector<std::vector<int64_t>> sizes;
    int n_threads = decode_shards(d, ids_flat, row_offsets, n_rows,
                                  skip_special, cleanup, out_flags, bufs,
                                  sizes);
    int64_t pos = 0;
    for (int t = 0; t < n_threads; ++t) {
        if (pos + (int64_t)bufs[(size_t)t].size() > cap) return -1;
        std::memcpy(out + pos, bufs[(size_t)t].data(), bufs[(size_t)t].size());
        int64_t lo = n_rows * t / n_threads;
        for (size_t j = 0; j < sizes[(size_t)t].size(); ++j) {
            out_offsets[lo + (int64_t)j] = pos;
            pos += sizes[(size_t)t][j];
        }
    }
    out_offsets[n_rows] = pos;
    return pos;
}

// Collect the distinct words in the corpus that are not yet in any cache
// (shared or thread 0's) and are <= max_wlen bytes — the candidate set for
// a device batch encode.  Words are appended to out_words back to back
// with lengths in out_lens; returns the word count (capped by cap_words /
// cap_bytes; the remainder is simply computed on the CPU path later, so
// capping is safe).
int64_t ctok_collect_miss_words(void* p, const uint8_t* joined,
                                const int64_t* offsets, int64_t n_texts,
                                int64_t max_wlen, uint8_t* out_words,
                                int32_t* out_lens, int64_t cap_words,
                                int64_t cap_bytes, int32_t n_threads) {
    Ctx* c = (Ctx*)p;
    // Probes ONLY the shared caches (under shared_mu), never the
    // per-thread ones: the scan can then run on the background fill
    // thread concurrently with host encodes.  Words a host thread has
    // already merged privately may be over-collected — the device fill
    // recomputes them once and the insert dedups; exactness never
    // depends on scan timing.
    std::lock_guard<std::mutex> lk(c->shared_mu);
    if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;
    if (n_threads > kMaxThreads) n_threads = kMaxThreads;
    if (n_texts < n_threads * 8) n_threads = 1;
    int64_t total = offsets[n_texts];
    struct ThreadOut {
        std::vector<uint8_t> words;
        std::vector<int32_t> lens;
    };
    std::vector<ThreadOut> touts((size_t)n_threads);
    auto worker = [&](int tid) {
        ShortCache seen_short;
        WordCache seen_long;
        int32_t sink[kMaxCachedWord];
        ThreadOut& to = touts[(size_t)tid];
        int64_t lo_b = total * tid / n_threads;
        int64_t hi_b = shard_hi(total, tid, n_threads);
        for (int64_t t = 0; t < n_texts; ++t) {
            int64_t a = offsets[t];
            if (a < lo_b || a >= hi_b) continue;
            const uint8_t* data = joined + a;
            int64_t n = offsets[t + 1] - a;
            for_each_word(c, data, n, [&](int64_t i, int64_t end) {
                int64_t wlen = end - i;
                if (wlen < 1 || wlen > max_wlen) return;
                bool known = false;
                if (wlen <= kMaxShortWord) {
                    uint64_t k0, k1;
                    load_key16_safe(data + i, wlen, &k0, &k1);
                    known =
                        (!c->shared_short.slots.empty() &&
                         c->shared_short.lookup(k0, k1, (uint8_t)wlen,
                                                sink) >= 0) ||
                        (!seen_short.slots.empty() &&
                         seen_short.lookup(k0, k1, (uint8_t)wlen, sink) >= 0);
                    if (!known)
                        seen_short.insert(k0, k1, (uint8_t)wlen, nullptr, 0);
                } else {
                    uint64_t h = fnv1a(data + i, wlen);
                    known = c->shared_long.find(h, data + i, wlen) >= 0 ||
                            seen_long.find(h, data + i, wlen) >= 0;
                    if (!known)
                        seen_long.insert(h, data + i, wlen, nullptr, 0);
                }
                if (!known) {
                    to.words.insert(to.words.end(), data + i, data + end);
                    to.lens.push_back((int32_t)wlen);
                }
            });
        }
    };
    pool().run(n_threads, worker);
    // ordered merge with cross-shard dedup (each shard is internally
    // distinct already; the global pass only filters inter-shard repeats)
    ShortCache g_short;
    WordCache g_long;
    int32_t sink[kMaxCachedWord];
    int64_t n_words = 0;
    int64_t byte_pos = 0;
    for (int t = 0; t < n_threads; ++t) {
        const ThreadOut& to = touts[(size_t)t];
        int64_t off = 0;
        for (int32_t wlen : to.lens) {
            const uint8_t* wp = to.words.data() + off;
            off += wlen;
            if (n_threads > 1) {
                bool dup;
                if (wlen <= kMaxShortWord) {
                    uint64_t k0, k1;
                    load_key16_safe(wp, wlen, &k0, &k1);
                    dup = !g_short.slots.empty() &&
                          g_short.lookup(k0, k1, (uint8_t)wlen, sink) >= 0;
                    if (!dup)
                        g_short.insert(k0, k1, (uint8_t)wlen, nullptr, 0);
                } else {
                    uint64_t h = fnv1a(wp, wlen);
                    dup = g_long.find(h, wp, wlen) >= 0;
                    if (!dup) g_long.insert(h, wp, wlen, nullptr, 0);
                }
                if (dup) continue;
            }
            if (n_words >= cap_words || byte_pos + wlen > cap_bytes)
                return n_words;
            std::memcpy(out_words + byte_pos, wp, (size_t)wlen);
            byte_pos += wlen;
            out_lens[n_words++] = (int32_t)wlen;
        }
    }
    return n_words;
}

// Insert precomputed word encodes (typically device-computed) into the
// shared caches.  Must not run concurrently with encode calls.
void ctok_cache_insert_batch(void* p, const uint8_t* words_buf,
                             const int64_t* word_offsets, int64_t n_words,
                             const int32_t* ids_buf,
                             const int64_t* ids_offsets) {
    Ctx* c = (Ctx*)p;
    std::lock_guard<std::mutex> lk(c->work_mu);
    std::lock_guard<std::mutex> lk2(c->shared_mu);
    for (int64_t w = 0; w < n_words; ++w) {
        const uint8_t* wp = words_buf + word_offsets[w];
        int64_t wlen = word_offsets[w + 1] - word_offsets[w];
        const int32_t* ids = ids_buf + ids_offsets[w];
        int64_t n_ids = ids_offsets[w + 1] - ids_offsets[w];
        if (wlen < 1 || wlen > kMaxCachedWord || n_ids > wlen) continue;
        if (wlen <= kMaxShortWord) {
            uint64_t k0, k1;
            load_key16_safe(wp, wlen, &k0, &k1);
            int32_t sink[kMaxShortWord];
            if (c->shared_short.slots.empty() ||
                c->shared_short.lookup(k0, k1, (uint8_t)wlen, sink) < 0)
                c->shared_short.insert(k0, k1, (uint8_t)wlen, ids, n_ids);
            if (wlen <= 8 && n_ids == 1)
                c->shared_front.insert1(k0, (uint32_t)wlen, ids[0]);
            else if (wlen <= 8 && n_ids == 2)
                c->shared_front.insert2(k0, (uint32_t)wlen, ids[0],
                                        ids[1]);
            else if (wlen > 8 && n_ids <= 2)
                c->shared_front16.insert(
                    k0, k1, ShortCache::mix(k0, k1, (uint64_t)wlen),
                    (uint32_t)wlen, ids, n_ids);
        } else {
            uint64_t h = fnv1a(wp, wlen);
            if (c->shared_long.find(h, wp, wlen) < 0)
                c->shared_long.insert(h, wp, wlen, ids, n_ids);
        }
    }
}

// Vocabulary warm-start: pre-merge n distinct words (flat buffer +
// offsets) through the raw merge loop and insert them into the SHARED
// caches.  Every vocab word's token sequence is derivable at load time
// from the merge table alone — by construction the vocab is the corpus
// head under any Zipf-ish distribution, so pre-merging it makes a fresh
// tokenizer's first batch serve warm (the TPU-native framework's answer
// to the reference re-merging every occurrence of every word,
// huggingface/mod.rs:601-605).  ids for word w are written at
// out_ids + word_offsets[w] (id count <= byte count) with counts in
// out_counts, so the caller can persist the result next to the
// tokenizer file and bulk-reload it via ctok_cache_insert_batch.
// The merge phase fans out over the pool; the shared-cache insert is
// serial (single-writer caches by design).  Returns total ids.
int64_t ctok_warm_start(void* p, const uint8_t* words_buf,
                        const int64_t* word_offsets, int64_t n_words,
                        int32_t* out_ids, int32_t* out_counts,
                        int32_t n_threads) {
    Ctx* c = (Ctx*)p;
    std::lock_guard<std::mutex> lk(c->work_mu);
    if (n_threads < 1) n_threads = 1;
    if (n_threads > kMaxThreads) n_threads = kMaxThreads;
    if (n_words < n_threads * 64) n_threads = 1;
    auto worker = [&](int tid) {
        std::vector<int32_t> scratch;
        scratch.reserve(64);
        int64_t total = word_offsets[n_words];
        int64_t lo_b = total * tid / n_threads;
        int64_t hi_b = shard_hi(total, tid, n_threads);
        for (int64_t w = 0; w < n_words; ++w) {
            int64_t a = word_offsets[w];
            if (a < lo_b || a >= hi_b) continue;
            int64_t b = word_offsets[w + 1];
            scratch.clear();
            for (int64_t k = a; k < b; ++k) {
                int32_t t = c->byte_token[words_buf[k]];
                if (t >= 0) scratch.push_back(t);
            }
            if (!scratch.empty()) merge_word(c, scratch);
            for (size_t i = 0; i < scratch.size(); ++i)
                out_ids[a + (int64_t)i] = scratch[i];
            out_counts[w] = (int32_t)scratch.size();
        }
    };
    pool().run(n_threads, worker);
    int64_t total_ids = 0;
    {
        std::lock_guard<std::mutex> lk2(c->shared_mu);
        for (int64_t w = 0; w < n_words; ++w) {
            int64_t a = word_offsets[w];
            int64_t wlen = word_offsets[w + 1] - a;
            const uint8_t* wp = words_buf + a;
            const int32_t* ids = out_ids + a;
            int64_t n_ids = out_counts[w];
            total_ids += n_ids;
            if (wlen < 1 || wlen > kMaxCachedWord) continue;
            if (wlen <= kMaxShortWord) {
                uint64_t k0, k1;
                load_key16_safe(wp, wlen, &k0, &k1);
                int32_t sink[kMaxShortWord];
                if (c->shared_short.slots.empty() ||
                    c->shared_short.lookup(k0, k1, (uint8_t)wlen, sink) < 0)
                    c->shared_short.insert(k0, k1, (uint8_t)wlen, ids, n_ids);
                if (wlen <= 8 && n_ids == 1)
                    c->shared_front.insert1(k0, (uint32_t)wlen, ids[0]);
                else if (wlen <= 8 && n_ids == 2)
                    c->shared_front.insert2(k0, (uint32_t)wlen, ids[0],
                                            ids[1]);
                else if (wlen > 8 && n_ids <= 2)
                    c->shared_front16.insert(
                        k0, k1, ShortCache::mix(k0, k1, (uint64_t)wlen),
                        (uint32_t)wlen, ids, n_ids);
            } else {
                uint64_t h = fnv1a(wp, wlen);
                if (c->shared_long.find(h, wp, wlen) < 0)
                    c->shared_long.insert(h, wp, wlen, ids, n_ids);
            }
        }
    }
    return total_ids;
}

// Multi-pattern gate: grouped by first byte so the common no-match case is
// one memchr sweep per distinct lead byte (SIMD, ~memory speed).  Used as
// the added-token routing gate (a byte-level superset of the
// orchestrator's added-token match, huggingface/mod.rs:616-692 — false
// positives only cost a host-path encode, never a wrong result).
struct PatternSet {
    const uint8_t* buf;
    const int64_t* offs;
    // patterns grouped by first byte; lead_bytes lists the non-empty
    // groups so the per-text scan never walks all 256 slots
    std::vector<int32_t> by_first[256];
    std::vector<uint8_t> lead_bytes;
    PatternSet(const uint8_t* pat_buf, const int64_t* pat_offsets,
               int64_t n_pats)
        : buf(pat_buf), offs(pat_offsets) {
        for (int64_t p = 0; p < n_pats; ++p)
            if (pat_offsets[p + 1] > pat_offsets[p]) {
                uint8_t f = pat_buf[pat_offsets[p]];
                if (by_first[f].empty()) lead_bytes.push_back(f);
                by_first[f].push_back((int32_t)p);
            }
    }
    bool matches(const uint8_t* text, int64_t len) const {
        for (uint8_t f : lead_bytes) {
            const auto& pats = by_first[f];
            const uint8_t* p = text;
            const uint8_t* end = text + len;
            while ((p = (const uint8_t*)memchr(p, f, end - p))) {
                int64_t rem = end - p;
                for (int32_t pi : pats) {
                    int64_t pl = offs[pi + 1] - offs[pi];
                    if (pl <= rem && memcmp(p, buf + offs[pi], pl) == 0)
                        return true;
                }
                ++p;
            }
        }
        return false;
    }

    // matches() over the *virtually prefixed* text ' '+text: the only
    // occurrence the plain scan can miss is a space-leading pattern
    // anchored at the virtual head.
    bool matches_pre(const uint8_t* text, int64_t len, bool pre) const {
        if (matches(text, len)) return true;
        if (!pre) return false;
        for (int32_t pi : by_first[(int)' ']) {
            int64_t pl = offs[pi + 1] - offs[pi];
            if (pl - 1 <= len &&
                memcmp(text, buf + offs[pi] + 1, (size_t)(pl - 1)) == 0)
                return true;
        }
        return false;
    }
};

// Batch encode over in-place text spans (no corpus join).  Each thread
// owns a contiguous text range (balanced by byte volume) and writes its
// ids *compacted* — text i's ids start right after text i-1's within the
// thread's block, whose base is out + offsets[first text of the thread].
// Compaction into the final flat buffer is then one memcpy per thread
// block instead of one per text.  A thread's ids never spill into the
// next block: ids <= bytes per text, and block t+1 starts at the byte
// offset of its first text.  skip[i] != 0 rows are passed through with
// count = -2 (caller normalizes and re-encodes them); pattern-gated rows
// get count = -1 (caller's exact added-token matcher).
// thread_base/thread_ids (size >= n_threads_used) record each block's
// flat base offset and total id count.  Returns the thread count used.
static int encode_batch_spans(Ctx* c, const uint8_t* const* ptrs,
                              const int64_t* szs, const uint8_t* pre,
                              const uint8_t* skip, const int64_t* offsets,
                              int64_t n_texts, const PatternSet* ps,
                              int32_t* out, int32_t* out_counts,
                              int64_t* thread_base, int64_t* thread_ids,
                              int n_threads) {
    std::lock_guard<std::mutex> lk(c->work_mu);
    if (n_threads < 1) n_threads = 1;
    if (n_threads > kMaxThreads) n_threads = kMaxThreads;
    if (n_texts < n_threads * 4) n_threads = 1;
    int64_t total = offsets[n_texts];
    // Work-stealing over byte-balanced SHARDS (more shards than
    // threads, pulled via an atomic counter): on a shared VM a static
    // two-way split stalls the whole batch whenever the neighbor steals
    // one core mid-batch — the other thread finishes and waits.  With
    // 8 shards per thread a preempted worker strands at most 1/16 of
    // the batch.  Output stays splice-compatible: shards are contiguous
    // text ranges in order, each compacted at its own first byte
    // offset (ids-per-text <= bytes-per-text bounds every shard's
    // region), and the caller memcpys blocks 0..n_used-1 in order.
    int n_shards = n_threads == 1
                       ? 1
                       : (int)std::min<int64_t>(kMaxThreads,
                                                (int64_t)n_threads * 8);
    std::atomic<int64_t> next_shard{0};
    auto worker = [&](int tid) {
        std::vector<int32_t> scratch;
        scratch.reserve(64);
        std::vector<uint8_t> tmp;
        WordCache* cache = &c->caches[tid];
        ShortCache* sc = &c->short_caches[tid];
        for (;;) {
            int64_t s = next_shard.fetch_add(1, std::memory_order_relaxed);
            if (s >= n_shards) break;
            int64_t lo_b = total * s / n_shards;
            int64_t hi_b = shard_hi(total, (int)s, n_shards);
            // first text whose start offset is >= lo_b
            int64_t i0 = (int64_t)(std::lower_bound(offsets, offsets + n_texts,
                                                    lo_b) -
                                   offsets);
            int64_t base = -1;
            int64_t pos = 0;
            for (int64_t i = i0; i < n_texts; ++i) {
                int64_t a = offsets[i];
                if (a >= hi_b) break;
                if (base < 0) base = a;
                if (skip && skip[i]) {
                    out_counts[i] = -2;
                    continue;
                }
                if (ps && ps->matches_pre(ptrs[i], szs[i], pre[i] != 0)) {
                    out_counts[i] = -1;
                    continue;
                }
                int64_t k = encode_text_span(c, cache, sc, ptrs[i], szs[i],
                                             pre[i] != 0, out + base + pos,
                                             scratch, tmp);
                out_counts[i] = (int32_t)k;
                pos += k;
            }
            thread_base[s] = base < 0 ? 0 : base;
            thread_ids[s] = pos;
        }
    };
    pool().run(n_threads, worker);
    return n_shards;
}

void ctok_match_any(const uint8_t* joined, const int64_t* offsets,
                    int64_t n_texts, const uint8_t* pat_buf,
                    const int64_t* pat_offsets, int64_t n_pats,
                    uint8_t* out_flags, int32_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > kMaxThreads) n_threads = kMaxThreads;
    if (n_texts < n_threads * 4) n_threads = 1;
    PatternSet ps(pat_buf, pat_offsets, n_pats);
    auto worker = [&](int tid) {
        int64_t total = offsets[n_texts];
        int64_t lo_b = total * tid / n_threads;
        int64_t hi_b = shard_hi(total, tid, n_threads);
        for (int64_t i = 0; i < n_texts; ++i) {
            int64_t a = offsets[i];
            if (a < lo_b || a >= hi_b) continue;
            out_flags[i] = ps.matches(joined + a, offsets[i + 1] - a) ? 1 : 0;
        }
    };
    pool().run(n_threads, worker);
}

// Fused gate + encode: texts where an added-token pattern occurs get
// out_counts[i] = -1 (caller routes them to the exact host matcher); all
// others are encoded as in ctok_encode_batch.  One pass, one thread pool.
void ctok_encode_batch_gated(void* p, const uint8_t* joined,
                             const int64_t* offsets, int64_t n_texts,
                             const uint8_t* pat_buf,
                             const int64_t* pat_offsets, int64_t n_pats,
                             int32_t* out, int32_t* out_counts,
                             int32_t n_threads) {
    Ctx* c = (Ctx*)p;
    std::lock_guard<std::mutex> lk(c->work_mu);
    if (n_threads < 1) n_threads = 1;
    if (n_threads > kMaxThreads) n_threads = kMaxThreads;
    if (n_texts < n_threads * 4) n_threads = 1;
    PatternSet ps(pat_buf, pat_offsets, n_pats);
    auto worker = [&](int tid) {
        std::vector<int32_t> scratch;
        scratch.reserve(64);
        WordCache* cache = &c->caches[tid];
        ShortCache* sc = &c->short_caches[tid];
        int64_t total = offsets[n_texts];
        int64_t lo_b = total * tid / n_threads;
        int64_t hi_b = shard_hi(total, tid, n_threads);
        for (int64_t i = 0; i < n_texts; ++i) {
            int64_t a = offsets[i];
            if (a < lo_b || a >= hi_b) continue;
            int64_t len = offsets[i + 1] - a;
            if (n_pats && ps.matches(joined + a, len)) {
                out_counts[i] = -1;
                continue;
            }
            out_counts[i] = (int32_t)encode_text(
                c, cache, sc, joined + a, len, out + a, scratch);
        }
    };
    pool().run(n_threads, worker);
}

// Segment pack: lay words back to back into [max_rows, W] byte rows (a
// word never spans rows), with per-position marks 1 = word start,
// 2 = continuation, 0 = pad, and each word's flat start position
// (row*W + col) in out_starts.  The dense layout keeps the device merge
// matrix ~95% occupied instead of one short word per 128-lane row —
// proportionally less transfer and compute per word.  Returns the number
// of words packed (may be < n_words when rows run out); *rows_used gets
// the row count actually touched.
int64_t ctok_pack_seg(const uint8_t* joined, const int64_t* offsets,
                      int64_t n_words, int64_t W, int64_t max_rows,
                      uint8_t* out_bytes, uint8_t* out_marks,
                      int64_t* out_starts, int64_t* rows_used) {
    std::memset(out_bytes, 0, (size_t)(max_rows * W));
    std::memset(out_marks, 0, (size_t)(max_rows * W));
    int64_t row = 0, col = 0, w = 0;
    for (; w < n_words; ++w) {
        int64_t a = offsets[w];
        int64_t len = offsets[w + 1] - a;
        if (len <= 0 || len > W) break;  // caller filters; safety stop
        if (col + len > W) {
            ++row;
            col = 0;
        }
        if (row >= max_rows) break;
        int64_t base = row * W + col;
        std::memcpy(out_bytes + base, joined + a, (size_t)len);
        out_marks[base] = 1;
        std::memset(out_marks + base + 1, 2, (size_t)(len - 1));
        out_starts[w] = base;
        col += len;
    }
    *rows_used = (row < max_rows) ? row + (col > 0 ? 1 : 0) : max_rows;
    return w;
}

// Batch pack: joined byte buffer + offsets -> zero-padded [B, L] matrix.
void ctok_pack(const uint8_t* joined, const int64_t* offsets, int64_t B,
               int64_t L, uint8_t* out, int32_t* lens) {
    std::memset(out, 0, (size_t)(B * L));
    for (int64_t i = 0; i < B; ++i) {
        int64_t a = offsets[i], b = offsets[i + 1];
        int64_t m = b - a;
        if (m > L) m = L;
        std::memcpy(out + i * L, joined + a, (size_t)m);
        lens[i] = (int32_t)m;
    }
}

}  // extern "C"

#ifdef CTOK_WITH_PYTHON
// ---------------------------------------------------------------------------
// Optional CPython extension surface (same .so doubles as ctypes library and
// importable module).  Fuses the whole Python-side batch prep — UTF-8 access
// via the unicode object's cached buffer, prefix-space handling, corpus
// join, offsets, added-token gate, encode, ragged compaction — into one
// call with the GIL released around the multithreaded encode.
// ---------------------------------------------------------------------------
#include <Python.h>

static PyObject* ctok_py_encode_ragged(PyObject*, PyObject* args) {
    unsigned long long addr;
    PyObject* texts_obj;
    int aps;
    PyObject* pats_obj;
    int n_threads;
    int ascii_norm = 0;  // 1: flag non-ASCII rows back (count == -2) so the
                         // caller can apply its Unicode normalizer to them
    if (!PyArg_ParseTuple(args, "KOiOi|i", &addr, &texts_obj, &aps, &pats_obj,
                          &n_threads, &ascii_norm))
        return nullptr;
    Ctx* c = (Ctx*)(uintptr_t)addr;

    PyObject* seq = PySequence_Fast(texts_obj, "texts must be a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    std::vector<const uint8_t*> ptrs((size_t)n);
    std::vector<int64_t> szs((size_t)n);
    std::vector<uint8_t> pre((size_t)n);
    std::vector<uint8_t> skip;
    if (ascii_norm) skip.resize((size_t)n, 0);
    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject* t = PySequence_Fast_GET_ITEM(seq, i);
        Py_ssize_t sz;
        const char* u = PyUnicode_AsUTF8AndSize(t, &sz);
        if (!u) {
            Py_DECREF(seq);
            return nullptr;
        }
        ptrs[i] = (const uint8_t*)u;
        szs[i] = (int64_t)sz;
        pre[i] = (uint8_t)(aps && sz > 0 && u[0] != ' ');
        if (ascii_norm && !PyUnicode_IS_ASCII(t)) skip[(size_t)i] = 1;
    }

    // patterns: sequence of bytes objects (may be empty)
    PyObject* pats_seq = PySequence_Fast(pats_obj, "patterns must be a sequence");
    if (!pats_seq) {
        Py_DECREF(seq);
        return nullptr;
    }
    Py_ssize_t n_pats = PySequence_Fast_GET_SIZE(pats_seq);
    std::vector<uint8_t> pat_buf;
    std::vector<int64_t> pat_offsets((size_t)n_pats + 1, 0);
    for (Py_ssize_t p = 0; p < n_pats; ++p) {
        char* pb;
        Py_ssize_t pl;
        if (PyBytes_AsStringAndSize(PySequence_Fast_GET_ITEM(pats_seq, p),
                                    &pb, &pl) < 0) {
            Py_DECREF(seq);
            Py_DECREF(pats_seq);
            return nullptr;
        }
        pat_buf.insert(pat_buf.end(), (uint8_t*)pb, (uint8_t*)pb + pl);
        pat_offsets[(size_t)p + 1] = (int64_t)pat_buf.size();
    }

    // Encode straight from the unicode objects' cached UTF-8 buffers —
    // no corpus join, no per-call multi-MB allocations (Ctx arenas are
    // reused across calls).  call_mu serializes arena users and is only
    // ever taken with the GIL released; the GIL is then re-acquired while
    // still holding it for the output build (safe: no thread waits on
    // call_mu while holding the GIL).
    PyThreadState* tstate = PyEval_SaveThread();
    c->call_mu.lock();
    int64_t* offsets = c->offsets_arena.ensure((size_t)n + 1);
    offsets[0] = 0;
    for (Py_ssize_t i = 0; i < n; ++i)
        offsets[i + 1] = offsets[i] + szs[(size_t)i] + pre[(size_t)i];
    int64_t total = offsets[n];
    int32_t* out = c->out_arena.ensure((size_t)(total > 0 ? total : 1));
    int32_t* counts = c->counts_arena.ensure((size_t)(n > 0 ? n : 1));
    // the arena is reused across calls: zero counts so a row the
    // partition could ever miss reads as empty, never as stale garbage
    std::memset(counts, 0, (size_t)(n > 0 ? n : 1) * sizeof(int32_t));
    int64_t thread_base[kMaxThreads];
    int64_t thread_ids[kMaxThreads];
    int n_used;
    {
        PatternSet ps(pat_buf.data(), pat_offsets.data(), n_pats);
        n_used = encode_batch_spans(
            c, ptrs.data(), szs.data(), pre.data(),
            skip.empty() ? nullptr : skip.data(), offsets, n,
            n_pats ? &ps : nullptr, out, counts, thread_base, thread_ids,
            n_threads);
    }
    PyEval_RestoreThread(tstate);

    // flagged rows (count == -1 added-token candidates, -2 non-ASCII under
    // ascii_norm) are compacted as empty; the caller re-encodes and
    // splices them (rare)
    PyObject* flagged = nullptr;
    PyObject* nonascii = nullptr;
    bool fail = false;
    int64_t total_ids = 0;
    for (Py_ssize_t i = 0; i < n; ++i)
        if (counts[(size_t)i] > 0) total_ids += counts[(size_t)i];
    PyObject* flat_b =
        PyByteArray_FromStringAndSize(nullptr, total_ids * (Py_ssize_t)sizeof(int32_t));
    PyObject* off_b = PyByteArray_FromStringAndSize(
        nullptr, (n + 1) * (Py_ssize_t)sizeof(int64_t));
    if (!flat_b || !off_b) {
        fail = true;
    } else {
        int32_t* flat = (int32_t*)PyByteArray_AS_STRING(flat_b);
        int64_t* row_off = (int64_t*)PyByteArray_AS_STRING(off_b);
        // ids are already compacted within each thread's block: one
        // memcpy per block instead of one per text
        int64_t pos = 0;
        for (int t = 0; t < n_used; ++t) {
            if (thread_ids[t] > 0) {
                std::memcpy(flat + pos, out + thread_base[t],
                            (size_t)thread_ids[t] * sizeof(int32_t));
                pos += thread_ids[t];
            }
        }
        int64_t acc = 0;
        for (Py_ssize_t i = 0; i < n && !fail; ++i) {
            row_off[i] = acc;
            int32_t cnt = counts[(size_t)i];
            if (cnt > 0) {
                acc += cnt;
            } else if (cnt < 0) {
                PyObject** lst = cnt == -1 ? &flagged : &nonascii;
                if (!*lst) *lst = PyList_New(0);
                PyObject* idx = PyLong_FromSsize_t(i);
                if (!*lst || !idx || PyList_Append(*lst, idx) < 0) fail = true;
                Py_XDECREF(idx);
            }
        }
        row_off[n] = acc;
    }
    c->call_mu.unlock();
    Py_DECREF(pats_seq);
    Py_DECREF(seq);
    if (fail) {
        Py_XDECREF(flat_b);
        Py_XDECREF(off_b);
        Py_XDECREF(flagged);
        Py_XDECREF(nonascii);
        return nullptr;
    }
    if (!flagged) {
        flagged = Py_None;
        Py_INCREF(Py_None);
    }
    if (!nonascii) {
        nonascii = Py_None;
        Py_INCREF(Py_None);
    }
    return Py_BuildValue("(NNNN)", flat_b, off_b, flagged, nonascii);
}

// Token-id PyLong interning: ids repeat constantly (vocab-bounded), so
// list building INCREFs one shared immutable int per id instead of
// allocating ~tokens-many fresh PyLongs.  GIL held at every use; cache
// lives for the module lifetime.
static std::vector<PyObject*> g_long_cache;

static inline PyObject* cached_long(int32_t v) {
    if (v < 0 || v >= (1 << 21)) return PyLong_FromLong(v);
    if ((size_t)v >= g_long_cache.size())
        g_long_cache.resize((size_t)v + 1024, nullptr);
    PyObject* o = g_long_cache[(size_t)v];
    if (!o) {
        o = PyLong_FromLong(v);
        if (!o) return nullptr;
        g_long_cache[(size_t)v] = o;
    }
    Py_INCREF(o);
    return o;
}

// Bulk row fill from an int32 id span: ensures every id's interned
// PyLong exists once (slow path), then runs a tight load/INCREF/store
// loop against the hoisted cache base — the per-element work drops to
// two memory ops + a refcount bump.  Returns false on alloc failure
// (caller owns row cleanup).
static inline bool store_cached_longs(PyObject** dst, const int32_t* src,
                                      int64_t n) {
    // pass 1 (cheap in the common warm case): materialize missing entries
    int64_t max_v = -1;
    for (int64_t k = 0; k < n; ++k)
        if (src[k] > max_v) max_v = src[k];
    if (max_v >= 0 && max_v < (1 << 21) &&
        (size_t)max_v >= g_long_cache.size())
        g_long_cache.resize((size_t)max_v + 1024, nullptr);
    PyObject** base = g_long_cache.data();
    size_t cache_n = g_long_cache.size();
    for (int64_t k = 0; k < n; ++k) {
        int32_t v = src[k];
        PyObject* o;
        if ((uint32_t)v < cache_n && (o = base[(size_t)v]) != nullptr) {
            Py_INCREF(o);
        } else {
            o = cached_long(v);
            if (!o) return false;
            base = g_long_cache.data();  // cached_long may resize
            cache_n = g_long_cache.size();
        }
        dst[k] = o;
    }
    return true;
}

// Fill n list slots with the SAME object: pointer stores + one refcount
// adjustment instead of n INCREFs.  Immortal objects (3.12 small ints)
// keep their saturated refcount untouched.
static inline void fill_same(PyObject** dst, PyObject* o, Py_ssize_t n) {
    for (Py_ssize_t i = 0; i < n; ++i) dst[i] = o;
#if PY_VERSION_HEX >= 0x030C0000
    if (!_Py_IsImmortal(o)) Py_SET_REFCNT(o, Py_REFCNT(o) + n);
#else
    Py_SET_REFCNT(o, Py_REFCNT(o) + n);
#endif
}

// Same fused pipeline as encode_ragged but materializes list[list[int]]
// directly in C (one pass of PyLong construction instead of 10K numpy
// .tolist() round-trips).  Flagged rows come back as None for the caller
// to host-encode.
static PyObject* ctok_py_encode_rows(PyObject* self, PyObject* args) {
    PyObject* tup = ctok_py_encode_ragged(self, args);
    if (!tup) return nullptr;
    PyObject* flat_b = PyTuple_GET_ITEM(tup, 0);
    PyObject* off_b = PyTuple_GET_ITEM(tup, 1);
    PyObject* flagged = PyTuple_GET_ITEM(tup, 2);
    PyObject* nonascii = PyTuple_GET_ITEM(tup, 3);
    const int32_t* flat = (const int32_t*)PyByteArray_AS_STRING(flat_b);
    const int64_t* off = (const int64_t*)PyByteArray_AS_STRING(off_b);
    Py_ssize_t n = PyByteArray_GET_SIZE(off_b) / (Py_ssize_t)sizeof(int64_t) - 1;
    PyObject* rows = PyList_New(n);
    if (!rows) {
        Py_DECREF(tup);
        return nullptr;
    }
    std::vector<uint8_t> is_flagged((size_t)(n > 0 ? n : 1), 0);
    for (PyObject* fl : {flagged, nonascii}) {
        if (fl == Py_None) continue;
        Py_ssize_t nf = PyList_GET_SIZE(fl);
        for (Py_ssize_t k = 0; k < nf; ++k) {
            Py_ssize_t idx = PyLong_AsSsize_t(PyList_GET_ITEM(fl, k));
            if (idx >= 0 && idx < n) is_flagged[(size_t)idx] = 1;
        }
    }
    for (Py_ssize_t i = 0; i < n; ++i) {
        if (is_flagged[(size_t)i]) {
            Py_INCREF(Py_None);
            PyList_SET_ITEM(rows, i, Py_None);
            continue;
        }
        Py_ssize_t m = (Py_ssize_t)(off[i + 1] - off[i]);
        PyObject* row = PyList_New(m);
        if (!row) {
            Py_DECREF(rows);
            Py_DECREF(tup);
            return nullptr;
        }
        const int32_t* src = flat + off[i];
        for (Py_ssize_t k = 0; k < m; ++k) {
            PyObject* v = cached_long(src[k]);
            if (!v) {
                Py_DECREF(row);
                Py_DECREF(rows);
                Py_DECREF(tup);
                return nullptr;
            }
            PyList_SET_ITEM(row, k, v);
        }
        PyList_SET_ITEM(rows, i, row);
    }
    Py_DECREF(tup);
    return rows;
}

// Corpus word-frequency count for the trainer (trainer.rs:247-263): the
// same scanner as the encode path, accumulating per-thread hash maps that
// merge into a Python dict {raw word bytes: count}.  min_len filters on
// byte length (== encoded char length, the byte-level alphabet is
// one-char-per-byte).
static PyObject* ctok_py_count_words(PyObject*, PyObject* args) {
    unsigned long long addr;
    PyObject* texts_obj;
    long long min_len;
    int n_threads;
    if (!PyArg_ParseTuple(args, "KOLi", &addr, &texts_obj, &min_len,
                          &n_threads))
        return nullptr;
    Ctx* c = (Ctx*)(uintptr_t)addr;
    PyObject* seq = PySequence_Fast(texts_obj, "texts must be a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    std::vector<const char*> ptrs((size_t)n);
    std::vector<Py_ssize_t> szs((size_t)n);
    int64_t total = 0;
    for (Py_ssize_t i = 0; i < n; ++i) {
        Py_ssize_t sz;
        const char* u =
            PyUnicode_AsUTF8AndSize(PySequence_Fast_GET_ITEM(seq, i), &sz);
        if (!u) {
            Py_DECREF(seq);
            return nullptr;
        }
        ptrs[i] = u;
        szs[i] = sz;
        total += sz;
    }
    std::unique_ptr<uint8_t[]> joined(new uint8_t[(size_t)(total > 0 ? total : 1)]);
    std::vector<int64_t> offsets((size_t)n + 1, 0);
    {
        int64_t pos = 0;
        for (Py_ssize_t i = 0; i < n; ++i) {
            std::memcpy(joined.get() + pos, ptrs[i], (size_t)szs[i]);
            pos += szs[i];
            offsets[(size_t)i + 1] = pos;
        }
    }
    Py_DECREF(seq);

    if (n_threads < 1) n_threads = 1;
    if (n_threads > kMaxThreads) n_threads = kMaxThreads;
    if (n < n_threads * 4) n_threads = 1;
    std::vector<std::unordered_map<std::string, int64_t>> maps(
        (size_t)n_threads);
    Py_BEGIN_ALLOW_THREADS
    {
        auto worker = [&](int tid) {
            auto& m = maps[(size_t)tid];
            m.reserve(1 << 14);
            int64_t lo_b = total * tid / n_threads;
            int64_t hi_b = shard_hi(total, tid, n_threads);
            for (Py_ssize_t t = 0; t < n; ++t) {
                int64_t a = offsets[(size_t)t];
                if (a < lo_b || a >= hi_b) continue;
                const uint8_t* data = joined.get() + a;
                int64_t len = offsets[(size_t)t + 1] - a;
                int64_t i = 0;
                while (i < len) {
                    int64_t end = word_end_at(c, data, len, i);
                    if (end - i >= min_len)
                        ++m[std::string((const char*)data + i,
                                        (size_t)(end - i))];
                    i = end;
                }
            }
        };
        pool().run(n_threads, worker);
        for (int t = 1; t < n_threads; ++t) {
            for (auto& kv : maps[(size_t)t]) maps[0][kv.first] += kv.second;
            maps[(size_t)t].clear();
        }
    }
    Py_END_ALLOW_THREADS

    PyObject* d = PyDict_New();
    if (!d) return nullptr;
    for (auto& kv : maps[0]) {
        PyObject* k =
            PyBytes_FromStringAndSize(kv.first.data(), (Py_ssize_t)kv.first.size());
        PyObject* v = PyLong_FromLongLong(kv.second);
        if (!k || !v || PyDict_SetItem(d, k, v) < 0) {
            Py_XDECREF(k);
            Py_XDECREF(v);
            Py_DECREF(d);
            return nullptr;
        }
        Py_DECREF(k);
        Py_DECREF(v);
    }
    return d;
}

// Single-text encode with minimal overhead: cached UTF-8 view, optional
// prefix space, added-token gate, encode, PyList build — one C call.
// Returns None when an added-token pattern matches (caller's host path).
static PyObject* ctok_py_encode_one(PyObject*, PyObject* args) {
    unsigned long long addr;
    PyObject* text_obj;
    int aps;
    PyObject* pats_obj;
    if (!PyArg_ParseTuple(args, "KUiO", &addr, &text_obj, &aps, &pats_obj))
        return nullptr;
    Ctx* c = (Ctx*)(uintptr_t)addr;
    Py_ssize_t sz;
    const char* u = PyUnicode_AsUTF8AndSize(text_obj, &sz);
    if (!u) return nullptr;
    const uint8_t* data = (const uint8_t*)u;
    int64_t n = (int64_t)sz;
    // stack buffer for short texts, heap for long
    uint8_t stack_buf[1024];
    std::unique_ptr<uint8_t[]> heap_buf;
    bool need_prefix = aps && n > 0 && data[0] != ' ';
    if (need_prefix) {
        uint8_t* b;
        if (n + 1 <= (int64_t)sizeof(stack_buf)) {
            b = stack_buf;
        } else {
            heap_buf.reset(new uint8_t[(size_t)n + 1]);
            b = heap_buf.get();
        }
        b[0] = ' ';
        std::memcpy(b + 1, data, (size_t)n);
        data = b;
        ++n;
    }
    // added-token gate
    Py_ssize_t n_pats = 0;
    if (pats_obj != Py_None) {
        PyObject* pats_seq =
            PySequence_Fast(pats_obj, "patterns must be a sequence");
        if (!pats_seq) return nullptr;
        n_pats = PySequence_Fast_GET_SIZE(pats_seq);
        for (Py_ssize_t p = 0; p < n_pats; ++p) {
            char* pb;
            Py_ssize_t pl;
            if (PyBytes_AsStringAndSize(PySequence_Fast_GET_ITEM(pats_seq, p),
                                        &pb, &pl) < 0) {
                Py_DECREF(pats_seq);
                return nullptr;
            }
            if (pl > 0 && pl <= n &&
                memmem(data, (size_t)n, pb, (size_t)pl)) {
                Py_DECREF(pats_seq);
                Py_RETURN_NONE;
            }
        }
        Py_DECREF(pats_seq);
    }
    int32_t stack_out[1024];
    std::unique_ptr<int32_t[]> heap_out;
    int32_t* out = stack_out;
    if (n > (int64_t)(sizeof(stack_out) / sizeof(int32_t))) {
        heap_out.reset(new int32_t[(size_t)(n > 0 ? n : 1)]);
        out = heap_out.get();
    }
    std::vector<int32_t> scratch;
    scratch.reserve(64);
    int64_t m;
    {
        std::lock_guard<std::mutex> lk(c->work_mu);
        m = encode_text(c, &c->caches[0], &c->short_caches[0], data, n, out,
                        scratch);
    }
    PyObject* lst = PyList_New((Py_ssize_t)m);
    if (!lst) return nullptr;
    for (int64_t i = 0; i < m; ++i) {
        PyObject* v = cached_long(out[i]);
        if (!v) {
            Py_DECREF(lst);
            return nullptr;
        }
        PyList_SET_ITEM(lst, (Py_ssize_t)i, v);
    }
    return lst;
}

// Ragged batch decode with direct str materialization: runs
// ctok_decode_batch with the GIL released, then builds the result list
// straight from the C output buffer (no intermediate bytes copy, no
// per-row Python slicing).  Rows flagged invalid-UTF-8 come back as None
// plus their indices, for the caller's exact lossy host path.
static PyObject* ctok_py_decode_ragged(PyObject*, PyObject* args) {
    unsigned long long addr;
    PyObject* ids_obj;
    PyObject* offs_obj;
    int skip_special, cleanup;
    if (!PyArg_ParseTuple(args, "KOOii", &addr, &ids_obj, &offs_obj,
                          &skip_special, &cleanup))
        return nullptr;
    Py_buffer ids_buf, offs_buf;
    if (PyObject_GetBuffer(ids_obj, &ids_buf, PyBUF_C_CONTIGUOUS) < 0)
        return nullptr;
    if (PyObject_GetBuffer(offs_obj, &offs_buf, PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&ids_buf);
        return nullptr;
    }
    const int32_t* ids_flat = (const int32_t*)ids_buf.buf;
    const int64_t* row_offsets = (const int64_t*)offs_buf.buf;
    int64_t n = (int64_t)(offs_buf.len / (Py_ssize_t)sizeof(int64_t)) - 1;
    if (n < 0 ||
        (n > 0 && (row_offsets[n] < 0 ||
                   row_offsets[n] > (int64_t)(ids_buf.len /
                                              (Py_ssize_t)sizeof(int32_t))))) {
        PyBuffer_Release(&ids_buf);
        PyBuffer_Release(&offs_buf);
        PyErr_SetString(PyExc_ValueError, "inconsistent ragged decode input");
        return nullptr;
    }
    std::vector<uint8_t> flags((size_t)(n > 0 ? n : 1), 0);
    std::vector<std::vector<uint8_t>> bufs;
    std::vector<std::vector<int64_t>> sizes;
    int n_threads = 1;
    Py_BEGIN_ALLOW_THREADS
    n_threads = decode_shards((const DecCtx*)(uintptr_t)addr, ids_flat,
                              row_offsets, n, skip_special, cleanup,
                              flags.data(), bufs, sizes);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&ids_buf);
    PyBuffer_Release(&offs_buf);
    PyObject* lst = PyList_New((Py_ssize_t)n);
    if (!lst) return nullptr;
    PyObject* flagged = nullptr;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = n * t / n_threads;
        const uint8_t* base = bufs[(size_t)t].data();
        int64_t pos = 0;
        for (size_t j = 0; j < sizes[(size_t)t].size(); ++j) {
            int64_t i = lo + (int64_t)j;
            if (flags[(size_t)i]) {
                Py_INCREF(Py_None);
                PyList_SET_ITEM(lst, (Py_ssize_t)i, Py_None);
                if (!flagged) flagged = PyList_New(0);
                PyObject* idx = PyLong_FromLongLong((long long)i);
                if (!idx || !flagged || PyList_Append(flagged, idx) < 0) {
                    Py_XDECREF(idx);
                    Py_XDECREF(flagged);
                    Py_DECREF(lst);
                    return nullptr;
                }
                Py_DECREF(idx);
            } else {
                PyObject* s = PyUnicode_DecodeUTF8(
                    (const char*)base + pos,
                    (Py_ssize_t)sizes[(size_t)t][j], nullptr);
                if (!s) {
                    Py_XDECREF(flagged);
                    Py_DECREF(lst);
                    return nullptr;
                }
                PyList_SET_ITEM(lst, (Py_ssize_t)i, s);
            }
            pos += sizes[(size_t)t][j];
        }
    }
    if (!flagged) {
        flagged = Py_None;
        Py_INCREF(Py_None);
    }
    return Py_BuildValue("(NN)", lst, flagged);
}

// Build the final framed/truncated/padded id lists for the transformers
// __call__ fast path in one pass: row = prefix + base + suffix, cut to
// trunc_len (-1 = no truncation), padded to pad_to (-1 = none; rows
// already longer stay as-is, matching Encoding.pad's early return).
// Per-row frame lengths shared by frame_rows / frame_matrix (and mirrored
// by ColumnarBatchEncoding.__init__): nb ids framed by p prefix + s suffix
// tokens, right-truncated to trunc_len, padded up to pad_to.
static inline void frame_lens(int64_t nb, int64_t p, int64_t s,
                              int64_t trunc_len, int64_t pad_to, int64_t* t,
                              int64_t* final_len) {
    int64_t m = p + nb + s;
    *t = (trunc_len >= 0 && m > trunc_len) ? trunc_len : m;
    *final_len = (pad_to >= 0 && pad_to > *t) ? pad_to : *t;
}

// Row offsets must be non-negative, monotonic, and within flat —
// checked per row so a bad interior offset can never index out of bounds.
static inline bool frame_row_ok(const int64_t* offs, int64_t i,
                                int64_t flat_len) {
    return offs[i] >= 0 && offs[i + 1] >= offs[i] && offs[i + 1] <= flat_len;
}

static PyObject* ctok_py_frame_rows(PyObject*, PyObject* args) {
    PyObject *flat_obj, *offs_obj, *prefix_obj, *suffix_obj;
    long long trunc_len, pad_to;
    int pad_id, pad_left;
    if (!PyArg_ParseTuple(args, "OOOOLLii", &flat_obj, &offs_obj,
                          &prefix_obj, &suffix_obj, &trunc_len, &pad_to,
                          &pad_id, &pad_left))
        return nullptr;
    Py_buffer flat_buf, offs_buf;
    if (PyObject_GetBuffer(flat_obj, &flat_buf, PyBUF_C_CONTIGUOUS) < 0)
        return nullptr;
    if (PyObject_GetBuffer(offs_obj, &offs_buf, PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&flat_buf);
        return nullptr;
    }
    const int32_t* flat = (const int32_t*)flat_buf.buf;
    const int64_t* offs = (const int64_t*)offs_buf.buf;
    int64_t n = (int64_t)(offs_buf.len / (Py_ssize_t)sizeof(int64_t)) - 1;
    std::vector<int32_t> prefix, suffix;
    bool ok = n >= 0 &&
              (n == 0 || (offs[n] >= 0 &&
                          offs[n] <= (int64_t)(flat_buf.len /
                                               (Py_ssize_t)sizeof(int32_t))));
    for (PyObject* seq_obj : {prefix_obj, suffix_obj}) {
        if (!ok) break;
        PyObject* seq = PySequence_Fast(seq_obj, "prefix/suffix");
        if (!seq) { ok = false; break; }
        std::vector<int32_t>& dst = seq_obj == prefix_obj ? prefix : suffix;
        for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); ++i) {
            long v = PyLong_AsLong(PySequence_Fast_GET_ITEM(seq, i));
            if (v == -1 && PyErr_Occurred()) { ok = false; break; }
            dst.push_back((int32_t)v);
        }
        Py_DECREF(seq);
    }
    if (!ok) {
        PyBuffer_Release(&flat_buf);
        PyBuffer_Release(&offs_buf);
        if (!PyErr_Occurred())
            PyErr_SetString(PyExc_ValueError, "inconsistent frame_rows input");
        return nullptr;
    }
    int64_t p = (int64_t)prefix.size(), s = (int64_t)suffix.size();
    PyObject* rows = PyList_New((Py_ssize_t)n);
    if (!rows) {
        PyBuffer_Release(&flat_buf);
        PyBuffer_Release(&offs_buf);
        return nullptr;
    }
    int64_t flat_len = (int64_t)(flat_buf.len / (Py_ssize_t)sizeof(int32_t));
    for (int64_t i = 0; i < n; ++i) {
        if (!frame_row_ok(offs, i, flat_len)) {
            Py_DECREF(rows);
            PyBuffer_Release(&flat_buf);
            PyBuffer_Release(&offs_buf);
            PyErr_SetString(PyExc_ValueError, "inconsistent frame_rows input");
            return nullptr;
        }
        int64_t nb = offs[i + 1] - offs[i];
        int64_t t, final_len;
        frame_lens(nb, p, s, trunc_len, pad_to, &t, &final_len);
        PyObject* row = PyList_New((Py_ssize_t)final_len);
        if (!row) {
            Py_DECREF(rows);
            PyBuffer_Release(&flat_buf);
            PyBuffer_Release(&offs_buf);
            return nullptr;
        }
        int64_t w = pad_left ? final_len - t : 0;
        bool fail = false;
        // three straight segments (prefix | ids | suffix), each a tight
        // interned-store loop — no per-element segment branch
        PyObject** item = ((PyListObject*)row)->ob_item + w;
        int64_t np_ = t < p ? t : p;
        int64_t nid = t - p < nb ? (t - p > 0 ? t - p : 0) : nb;
        int64_t ns = t - p - nb > 0 ? t - p - nb : 0;
        if (!store_cached_longs(item, prefix.data(), np_) ||
            !store_cached_longs(item + np_, flat + offs[i], nid) ||
            !store_cached_longs(item + np_ + nid, suffix.data(), ns))
            fail = true;
        (void)w;
        int64_t pad_at = pad_left ? 0 : t;
        if (final_len > t && !fail) {
            PyObject* o = cached_long(pad_id);
            if (!o) {
                fail = true;
            } else {
                // fill_same adds final_len-t refs; then drop ours (AFTER
                // the fill — a fresh non-interned PyLong arrives at
                // refcount 1 and an early DECREF would free it)
                fill_same(((PyListObject*)row)->ob_item + pad_at, o,
                          (Py_ssize_t)(final_len - t));
                Py_DECREF(o);
            }
        }
        if (fail) {
            Py_DECREF(row);
            Py_DECREF(rows);
            PyBuffer_Release(&flat_buf);
            PyBuffer_Release(&offs_buf);
            return nullptr;
        }
        PyList_SET_ITEM(rows, (Py_ssize_t)i, row);
    }
    PyBuffer_Release(&flat_buf);
    PyBuffer_Release(&offs_buf);
    return rows;
}

// frame_matrix(flat, offs, prefix, suffix, trunc_len, pad_to, pad_id,
//              pad_left, out[B, L] int32 writable) -> None
//
// The dense-matrix twin of frame_rows: identical per-row semantics
// (frame = prefix + ids + suffix, right-truncated to trunc_len, padded to
// max(t, pad_to) on pad_left's side), but writes int32 directly into a
// caller-allocated [B, L] buffer instead of materializing PyLong rows —
// this is the return_tensors="np"/"jax" production path.  Positions past
// a row's final length are filled with pad_id so ragged finals stay valid.
static PyObject* ctok_py_frame_matrix(PyObject*, PyObject* args) {
    PyObject *flat_obj, *offs_obj, *prefix_obj, *suffix_obj, *out_obj;
    long long trunc_len, pad_to;
    int pad_id, pad_left;
    if (!PyArg_ParseTuple(args, "OOOOLLiiO", &flat_obj, &offs_obj,
                          &prefix_obj, &suffix_obj, &trunc_len, &pad_to,
                          &pad_id, &pad_left, &out_obj))
        return nullptr;
    Py_buffer flat_buf, offs_buf, out_buf;
    if (PyObject_GetBuffer(flat_obj, &flat_buf, PyBUF_C_CONTIGUOUS) < 0)
        return nullptr;
    if (PyObject_GetBuffer(offs_obj, &offs_buf, PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&flat_buf);
        return nullptr;
    }
    if (PyObject_GetBuffer(out_obj, &out_buf,
                           PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) < 0) {
        PyBuffer_Release(&flat_buf);
        PyBuffer_Release(&offs_buf);
        return nullptr;
    }
    const int32_t* flat = (const int32_t*)flat_buf.buf;
    const int64_t* offs = (const int64_t*)offs_buf.buf;
    int32_t* out = (int32_t*)out_buf.buf;
    int64_t n = (int64_t)(offs_buf.len / (Py_ssize_t)sizeof(int64_t)) - 1;
    int64_t out_elems = (int64_t)(out_buf.len / (Py_ssize_t)sizeof(int32_t));
    int64_t L = n > 0 ? out_elems / n : 0;
    std::vector<int32_t> prefix, suffix;
    bool ok = n >= 0 && (n == 0 || out_elems == n * L) &&
              (n == 0 || (offs[n] >= 0 &&
                          offs[n] <= (int64_t)(flat_buf.len /
                                               (Py_ssize_t)sizeof(int32_t))));
    for (PyObject* seq_obj : {prefix_obj, suffix_obj}) {
        if (!ok) break;
        PyObject* seq = PySequence_Fast(seq_obj, "prefix/suffix");
        if (!seq) { ok = false; break; }
        std::vector<int32_t>& dst = seq_obj == prefix_obj ? prefix : suffix;
        for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); ++i) {
            long v = PyLong_AsLong(PySequence_Fast_GET_ITEM(seq, i));
            if (v == -1 && PyErr_Occurred()) { ok = false; break; }
            dst.push_back((int32_t)v);
        }
        Py_DECREF(seq);
    }
    int64_t p = (int64_t)prefix.size(), s = (int64_t)suffix.size();
    if (ok) {
        int64_t flat_len =
            (int64_t)(flat_buf.len / (Py_ssize_t)sizeof(int32_t));
        for (int64_t i = 0; i < n && ok; ++i) {
            if (!frame_row_ok(offs, i, flat_len)) { ok = false; break; }
            int64_t nb = offs[i + 1] - offs[i];
            int64_t t, final_len;
            frame_lens(nb, p, s, trunc_len, pad_to, &t, &final_len);
            if (final_len > L) { ok = false; break; }
            int32_t* row = out + i * L;
            std::fill(row, row + L, (int32_t)pad_id);
            int64_t w = pad_left ? final_len - t : 0;
            int64_t k = 0;
            for (; k < t && k < p; ++k) row[w++] = prefix[(size_t)k];
            int64_t nid = std::min(t - k, nb);
            if (nid > 0) {
                std::memcpy(row + w, flat + offs[i] + (k - p),
                            (size_t)nid * sizeof(int32_t));
                w += nid;
                k += nid;
            }
            for (; k < t; ++k) row[w++] = suffix[(size_t)(k - p - nb)];
        }
    }
    PyBuffer_Release(&flat_buf);
    PyBuffer_Release(&offs_buf);
    PyBuffer_Release(&out_buf);
    if (!ok) {
        if (!PyErr_Occurred())
            PyErr_SetString(PyExc_ValueError, "inconsistent frame_matrix input");
        return nullptr;
    }
    Py_RETURN_NONE;
}

// split_words(ctx, text, add_prefix_space) -> bytes of int64 boundaries
// over the (virtually prefixed) UTF-8 text: n+1 offsets, offsets[0] == 0.
// The same GPT-2 simplified scan as the encode path, boundaries only.
static PyObject* ctok_py_split_words(PyObject*, PyObject* args) {
    unsigned long long addr;
    PyObject* text_obj;
    int aps;
    if (!PyArg_ParseTuple(args, "KUi", &addr, &text_obj, &aps))
        return nullptr;
    Ctx* c = (Ctx*)(uintptr_t)addr;
    Py_ssize_t sz;
    const char* u = PyUnicode_AsUTF8AndSize(text_obj, &sz);
    if (!u) return nullptr;
    const uint8_t* data = (const uint8_t*)u;
    int64_t n = (int64_t)sz;
    uint8_t stack_buf[1024];
    std::unique_ptr<uint8_t[]> heap_buf;
    if (aps && n > 0 && data[0] != ' ') {
        uint8_t* b;
        if (n + 1 <= (int64_t)sizeof(stack_buf)) {
            b = stack_buf;
        } else {
            heap_buf.reset(new uint8_t[(size_t)n + 1]);
            b = heap_buf.get();
        }
        b[0] = ' ';
        std::memcpy(b + 1, data, (size_t)n);
        data = b;
        ++n;
    }
    std::vector<int64_t> bounds;
    bounds.reserve((size_t)(n / 4 + 2));
    bounds.push_back(0);
    int64_t i = 0;
    while (i < n) {
        int64_t end = word_end_at(c, data, n, i);
        bounds.push_back(end);
        i = end;
    }
    return PyBytes_FromStringAndSize(
        (const char*)bounds.data(),
        (Py_ssize_t)(bounds.size() * sizeof(int64_t)));
}

// mask_rows(t int64[n], final int64[n], pad_left) -> list[list[int]]:
// attention-mask rows ([1]*t padded with 0 to final, on pad_left's side)
// built from interned 0/1 ints in one pass — the list-mode twin of the
// tensor-mode arange comparison.
static PyObject* ctok_py_mask_rows(PyObject*, PyObject* args) {
    PyObject *t_obj, *f_obj;
    int pad_left;
    if (!PyArg_ParseTuple(args, "OOi", &t_obj, &f_obj, &pad_left))
        return nullptr;
    Py_buffer t_buf, f_buf;
    if (PyObject_GetBuffer(t_obj, &t_buf, PyBUF_C_CONTIGUOUS) < 0)
        return nullptr;
    if (PyObject_GetBuffer(f_obj, &f_buf, PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&t_buf);
        return nullptr;
    }
    const int64_t* ts = (const int64_t*)t_buf.buf;
    const int64_t* fs = (const int64_t*)f_buf.buf;
    Py_ssize_t n = t_buf.len / (Py_ssize_t)sizeof(int64_t);
    PyObject* rows = nullptr;
    bool ok = f_buf.len == t_buf.len;
    if (ok) rows = PyList_New(n);
    PyObject* one = cached_long(1);
    PyObject* zero = cached_long(0);
    if (rows && one && zero) {
        for (Py_ssize_t i = 0; i < n && ok; ++i) {
            int64_t t = ts[i], f = fs[i];
            if (t < 0 || f < t) { ok = false; break; }
            PyObject* row = PyList_New((Py_ssize_t)f);
            if (!row) { ok = false; break; }
            int64_t ones_at = pad_left ? f - t : 0;
            PyObject** item = ((PyListObject*)row)->ob_item;
            if (ones_at > 0) fill_same(item, zero, (Py_ssize_t)ones_at);
            fill_same(item + ones_at, one, (Py_ssize_t)t);
            if (ones_at + t < f)
                fill_same(item + ones_at + t, zero,
                          (Py_ssize_t)(f - ones_at - t));
            PyList_SET_ITEM(rows, i, row);
        }
    } else {
        ok = false;
    }
    Py_XDECREF(one);
    Py_XDECREF(zero);
    PyBuffer_Release(&t_buf);
    PyBuffer_Release(&f_buf);
    if (!ok) {
        Py_XDECREF(rows);
        if (!PyErr_Occurred())
            PyErr_SetString(PyExc_ValueError, "inconsistent mask_rows input");
        return nullptr;
    }
    return rows;
}

// mask_matrix(t int64[n], final int64[n], pad_left, L, out int32[n, L])
// -> None: attention-mask rows written as int32 runs straight into the
// caller's matrix (the tensor-mode twin of mask_rows — no bool
// intermediate, no per-element Python work).  Positions past a row's
// final length stay 0.  L is the caller-stated row stride, validated
// against the buffer (inferring it from out_elems/n would silently
// accept a wrong-shaped buffer whose element count happens to divide).
static PyObject* ctok_py_mask_matrix(PyObject*, PyObject* args) {
    PyObject *t_obj, *f_obj, *out_obj;
    int pad_left;
    long long L_arg;
    if (!PyArg_ParseTuple(args, "OOiLO", &t_obj, &f_obj, &pad_left, &L_arg,
                          &out_obj))
        return nullptr;
    Py_buffer t_buf, f_buf, out_buf;
    if (PyObject_GetBuffer(t_obj, &t_buf, PyBUF_C_CONTIGUOUS) < 0)
        return nullptr;
    if (PyObject_GetBuffer(f_obj, &f_buf, PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&t_buf);
        return nullptr;
    }
    if (PyObject_GetBuffer(out_obj, &out_buf,
                           PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) < 0) {
        PyBuffer_Release(&t_buf);
        PyBuffer_Release(&f_buf);
        return nullptr;
    }
    const int64_t* ts = (const int64_t*)t_buf.buf;
    const int64_t* fs = (const int64_t*)f_buf.buf;
    int32_t* out = (int32_t*)out_buf.buf;
    Py_ssize_t n = t_buf.len / (Py_ssize_t)sizeof(int64_t);
    int64_t out_elems = (int64_t)(out_buf.len / (Py_ssize_t)sizeof(int32_t));
    int64_t L = (int64_t)L_arg;
    bool ok = f_buf.len == t_buf.len && L >= 0 && out_elems == (int64_t)n * L;
    for (Py_ssize_t i = 0; i < n && ok; ++i) {
        int64_t t = ts[i], f = fs[i];
        if (t < 0 || f < t || f > L) { ok = false; break; }
        int32_t* row = out + (int64_t)i * L;
        std::fill(row, row + L, 0);
        int64_t at = pad_left ? f - t : 0;
        std::fill(row + at, row + at + t, 1);
    }
    PyBuffer_Release(&t_buf);
    PyBuffer_Release(&f_buf);
    PyBuffer_Release(&out_buf);
    if (!ok) {
        PyErr_SetString(PyExc_ValueError, "inconsistent mask_matrix input");
        return nullptr;
    }
    Py_RETURN_NONE;
}

static PyMethodDef CtokExtMethods[] = {
    {"mask_matrix", ctok_py_mask_matrix, METH_VARARGS,
     "mask_matrix(t int64[n], final int64[n], pad_left, L, out int32[n, L])"
     " -> None (fills the matrix in place)"},
    {"frame_matrix", ctok_py_frame_matrix, METH_VARARGS,
     "frame_matrix(flat, offs, prefix, suffix, trunc_len, pad_to, pad_id, "
     "pad_left, out) -> None (fills the [B, L] int32 buffer in place)"},
    {"split_words", ctok_py_split_words, METH_VARARGS,
     "split_words(ctx, text, add_prefix_space) -> int64 boundary bytes "
     "over the prefixed UTF-8 text"},
    {"mask_rows", ctok_py_mask_rows, METH_VARARGS,
     "mask_rows(t int64[n], final int64[n], pad_left) -> list[list[int]]"},
    {"frame_rows", ctok_py_frame_rows, METH_VARARGS,
     "frame_rows(flat, offs, prefix, suffix, trunc_len, pad_to, pad_id, "
     "pad_left) -> list[list[int]]"},
    {"decode_ragged", ctok_py_decode_ragged, METH_VARARGS,
     "decode_ragged(dec_ctx, ids_flat, row_offsets, skip_special, cleanup)"
     " -> (list[str|None], flagged indices or None)"},
    {"encode_one", ctok_py_encode_one, METH_VARARGS,
     "encode_one(ctx, text, add_prefix_space, patterns_or_None) -> "
     "list[int] | None (None = added-token candidate)"},
    {"count_words", ctok_py_count_words, METH_VARARGS,
     "count_words(ctx, texts, min_len, n_threads) -> dict[bytes, int]"},
    {"encode_rows", ctok_py_encode_rows, METH_VARARGS,
     "encode_rows(ctx, texts, add_prefix_space, patterns, n_threads) -> "
     "list[list[int]] (None rows = added-token candidates)"},
    {"encode_ragged", ctok_py_encode_ragged, METH_VARARGS,
     "encode_ragged(ctx, texts, add_prefix_space, patterns, n_threads) -> "
     "(flat_ids bytearray, row_offsets bytearray, flagged indices or None)"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef ctok_ext_module = {
    PyModuleDef_HEAD_INIT, "_ctok_ext", nullptr, -1, CtokExtMethods,
    nullptr, nullptr, nullptr, nullptr};

extern "C" PyObject* PyInit__ctok_ext(void) {
    return PyModule_Create(&ctok_ext_module);
}
#endif  // CTOK_WITH_PYTHON
