// Native host-side ingest engine: telemetry line parsing, flow indexing
// with direction folding, and packed update-batch assembly.
//
// This is the C++ replacement for the host-bound half of the reference's
// ingest loop (traffic_classifier.py:144-171): where the reference splits
// strings and mutates per-flow Python objects one line at a time, this
// engine consumes raw pipe bytes in bulk and emits packed arrays that the
// PyTorch layer scatters into the device-resident flow table
// (core/flow_table.py). All counter math stays on device; this code only
// decides where each record goes (slot, direction, create flag) — the
// same contract as ingest/batcher.py's FlowIndex + Batcher, which remain
// as the pure-Python fallback and behavioral oracle.
//
// Hot-path design (the serving loop budget is the monitor's 1 Hz poll
// cadence, simple_monitor_13.py:36, at 2^20 tracked flows ≈ 1M records
// per tick):
//   - flow keys are deterministic 64-bit fingerprints of
//     (datapath\0src\0dst) — same keying rule as the Python oracle's
//     protocol.stable_flow_key, different (much faster) mix; see the
//     fingerprint section below for the collision-equivalence argument —
//     held in an open-addressing table: no per-record string allocation,
//     no chained-bucket pointer chases
//   - parsing (tokenize, int parse, UTF-8 validate, fingerprint) is
//     side-effect-free per line, so large chunks are split at line
//     boundaries and parsed on worker threads when the host has cores to
//     spare; ROUTING stays sequential in original record order, so slot
//     assignment is identical to the single-threaded oracle
//   - on a single-core host the threaded path auto-degrades to inline
//     parsing (no thread overhead)
//
// Semantics mirrored from the Python batcher (and ultimately from the
// reference's key folding at traffic_classifier.py:157-165):
//   - a record keys on (datapath, eth_src, eth_dst); if that key is new
//     but the reversed key exists, the record is the reverse direction of
//     the existing flow
//   - per (slot, direction) a batch generation holds at most one create
//     row and one update row; a second same-direction update starts a new
//     generation (conflict_start=true), so flushing generations in order
//     reproduces the reference's sequential per-line semantics exactly.
//     Uniqueness is enforced per RUN (all generations between conflicts /
//     drains), so consumers may concatenate a whole run into one scatter
//   - table-full records are dropped and counted
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// 64-bit flow fingerprint — a wyhash-style 128-bit-multiply mix over
// dp\0src\0dst. Deterministic (fixed seed, stable across processes and
// runs — the property the reference's per-process-randomized ``hash()``
// lacks, SURVEY.md §2 defect list) and well-mixed, at ~10 ns per key where
// a cryptographic digest costs ~220 ns — fingerprinting is the ingest hot
// loop's largest single cost at 1M records/tick.
//
// The Python control plane (ingest/protocol.stable_flow_key) uses
// BLAKE2b-64 for the same key. The two paths never share a table, and
// routing behavior depends only on fingerprint hit/miss patterns, so
// native and Python routing agree except when either function collides:
// birthday probability ~(2^20)²/2 / 2^64 = 2^-25 at 2^20 live flows —
// the same order as the Python path's own BLAKE2b-64 collision
// acceptance (both are 64-bit fingerprints; only the mixing function
// differs). A collision merges two flows' counters — the identical
// failure mode the oracle already accepts.
// ---------------------------------------------------------------------------

inline uint64_t mum_mix(uint64_t a, uint64_t b) {
  __uint128_t r = static_cast<__uint128_t>(a) * b;
  return static_cast<uint64_t>(r) ^ static_cast<uint64_t>(r >> 64);
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint64_t load_partial(const uint8_t* p, size_t n) {
  uint64_t v = 0;
  std::memcpy(&v, p, n);  // little-endian host assumed (x86/ARM LE)
  return v;
}

constexpr uint64_t kSeed0 = 0xa0761d6478bd642fULL;
constexpr uint64_t kSeed1 = 0xe7037ed1a0b428dbULL;
constexpr uint64_t kSeed2 = 0x8ebc6af09c88c6e3ULL;

uint64_t hash_bytes(const uint8_t* s, size_t len) {
  uint64_t h = kSeed0 ^ mum_mix(len, kSeed1);
  size_t i = 0;
  for (; i + 16 <= len; i += 16) {
    h = mum_mix(load64(s + i) ^ kSeed1, load64(s + i + 8) ^ h);
  }
  uint64_t a = 0, b = 0;
  size_t rem = len - i;
  if (rem > 8) {
    a = load64(s + i);
    b = load_partial(s + i + 8, rem - 8);
  } else if (rem > 0) {
    a = load_partial(s + i, rem);
  }
  return mum_mix(kSeed2 ^ a, h ^ b);
}

// Fingerprint of dp\0src\0dst (the \0 separators carry the same
// anti-ambiguity rule as protocol.stable_flow_key: 'ab'+'c' must not
// collide with 'a'+'bc'). A nonzero ``source`` appends \0 + the 4-byte
// little-endian source id — the fan-in tier's per-source namespace,
// mirroring stable_flow_key(source=): source 0 hashes the exact legacy
// byte string, so pre-fan-in checkpoints restore into the default
// namespace unchanged, and N sources reporting the same flow tuple
// occupy N disjoint slots.
uint64_t flow_fingerprint(const char* dp, size_t dpl, const char* src,
                          size_t sl, const char* dst, size_t dl,
                          uint32_t source) {
  const size_t total = dpl + sl + dl + 2 + (source != 0 ? 5 : 0);
  uint8_t stackbuf[512];
  std::vector<uint8_t> heapbuf;
  uint8_t* buf = stackbuf;
  if (total > sizeof(stackbuf)) {
    heapbuf.resize(total);
    buf = heapbuf.data();
  }
  std::memcpy(buf, dp, dpl);
  buf[dpl] = 0;
  std::memcpy(buf + dpl + 1, src, sl);
  buf[dpl + 1 + sl] = 0;
  std::memcpy(buf + dpl + 2 + sl, dst, dl);
  if (source != 0) {
    size_t o = dpl + 2 + sl + dl;
    buf[o] = 0;
    std::memcpy(buf + o + 1, &source, 4);  // little-endian host assumed
  }
  return hash_bytes(buf, total);
}

// ---------------------------------------------------------------------------
// Open-addressing fingerprint → slot map (linear probing, tombstones).
// The mum_mix fingerprint above is well-mixed across all 64 bits, so the
// fingerprint itself serves as the probe hash (no re-hash).
// ---------------------------------------------------------------------------

constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kTomb = 0xFFFFFFFEu;

struct FpMap {
  // Parallel keys[]/vals[] arrays, NOT interleaved 16-byte entries: an
  // interleave was tried (round 4) and measured ~10% SLOWER — probing
  // scans vals only (16 per line vs 4 entries per line), and the
  // route_block prefetch already covers both arrays' lines.
  std::vector<uint64_t> keys;
  std::vector<uint32_t> vals;
  size_t mask = 0;
  size_t used = 0;    // live entries
  size_t filled = 0;  // live + tombstones

  explicit FpMap(size_t initial = 1024) { reset(initial); }

  void reset(size_t cap) {
    size_t n = 16;
    while (n < cap) n <<= 1;
    keys.assign(n, 0);
    vals.assign(n, kEmpty);
    mask = n - 1;
    used = filled = 0;
  }

  uint32_t* find(uint64_t k) {
    size_t i = k & mask;
    while (true) {
      uint32_t v = vals[i];
      if (v == kEmpty) return nullptr;
      if (v != kTomb && keys[i] == k) return &vals[i];
      i = (i + 1) & mask;
    }
  }

  void grow() {
    std::vector<uint64_t> ok = std::move(keys);
    std::vector<uint32_t> ov = std::move(vals);
    size_t n = (used * 4 >= (mask + 1)) ? (mask + 1) * 2 : (mask + 1);
    keys.assign(n, 0);
    vals.assign(n, kEmpty);
    mask = n - 1;
    filled = used;
    for (size_t j = 0; j < ov.size(); j++) {
      if (ov[j] == kEmpty || ov[j] == kTomb) continue;
      size_t i = ok[j] & mask;
      while (vals[i] != kEmpty) i = (i + 1) & mask;
      keys[i] = ok[j];
      vals[i] = ov[j];
    }
  }

  void insert(uint64_t k, uint32_t v) {
    if ((filled + 1) * 2 >= mask + 1) grow();  // ≤50% load incl tombstones
    size_t i = k & mask;
    while (vals[i] != kEmpty && vals[i] != kTomb) i = (i + 1) & mask;
    if (vals[i] == kEmpty) filled++;
    keys[i] = k;
    vals[i] = v;
    used++;
  }

  void erase(uint64_t k) {
    uint32_t* p = find(k);
    if (p != nullptr) {
      *p = kTomb;
      used--;
    }
  }
};

// ---------------------------------------------------------------------------
// Engine
// ---------------------------------------------------------------------------

struct Row {
  uint32_t slot;
  int32_t time;
  uint64_t pkts;
  uint64_t bytes;
  uint8_t is_fwd;
  uint8_t is_create;
};

// One flush unit. The per-(slot,dir) occupancy that enforces the
// one-create-plus-one-update-per-direction limit lives in the Engine as
// an epoch-stamped flat array (occ_epoch/occ_bits) scoped to the RUN
// (see Engine) — only the newest generation ever accepts rows, and a
// bump of run_seq invalidates the whole array in O(1) instead of
// clearing.
struct Generation {
  std::vector<Row> rows;
  // True iff this generation was STARTED because a (slot, direction,
  // create/update) key already occupied the previous generation — the
  // flush consumer must then apply it in a separate scatter (duplicate
  // target rows in one scatter are undefined). Size-rollover generations
  // (rows reached max_batch) carry no such conflict and may be coalesced
  // with their predecessor by the sharded spine's batched apply.
  bool conflict_start = false;
};

// A parsed-but-not-yet-routed telemetry record. String views point into
// the feed buffer (or the tail scratch), valid for the duration of the
// feed() call — routing happens before feed() returns.
struct ParsedRec {
  uint64_t fp;    // fingerprint of (dp, src, dst)
  uint64_t rfp;   // fingerprint of (dp, dst, src); valid iff has_rfp
  const char* src;
  const char* dst;
  uint32_t src_len;
  uint32_t dst_len;
  const char* dp;
  uint32_t dp_len;
  int32_t time;
  uint64_t pkts;
  uint64_t bytes;
  uint8_t has_rfp;
};

struct Engine {
  uint32_t capacity;
  uint32_t max_batch;
  FpMap key_to_slot;
  std::vector<uint64_t> slot_fp;
  std::vector<uint8_t> slot_used;
  std::vector<std::string> slot_src;
  std::vector<std::string> slot_dst;
  // Per-slot telemetry-source namespace (0 = the default/legacy
  // namespace) — the reverse map behind tck_slots_for_source, i.e. the
  // native counterpart of FlowIndex.slot_source: a dead source's
  // quarantine eviction clears exactly its own slots. A flat vector,
  // not a sparse map: one uint32 per slot is 4 MB at 2^20 capacity and
  // the write is free inside the create path's cache lines.
  std::vector<uint32_t> slot_source;
  std::vector<uint32_t> free_slots;
  uint32_t next_slot = 0;
  uint64_t dropped = 0;
  uint64_t parsed = 0;
  // Malformed telemetry: lines that carry the 'data' prefix but fail
  // the parse (bad int, non-UTF8 field, too few fields). Noise lines
  // (Ryu logs, headers) are NOT errors — the reference's own stdout
  // interleaves them by design. Keyed per source so the fan-in tier
  // can attribute a corrupt feed to the switch that sent it.
  uint64_t parse_errors = 0;
  std::unordered_map<uint32_t, uint64_t> src_parse_errors;
  std::unordered_map<uint32_t, uint64_t> src_parsed;
  int32_t last_time = 0;  // max telemetry timestamp seen (eviction clock)
  std::deque<Generation> gens;
  // A RUN is a maximal sequence of coalescible generations: it ends at a
  // key conflict (a generation with conflict_start) or when the deque
  // drains empty (everything popped has been applied by then). Key
  // occupancy is tracked per RUN — not per generation — so a consumer
  // may concatenate every generation of a run into ONE device scatter:
  // (slot << 1 | is_fwd) bits valid iff occ_epoch[k] == run_seq
  // (bit0=create, bit1=update).
  uint32_t run_seq = 0;
  std::vector<uint32_t> occ_epoch;
  std::vector<uint8_t> occ_bits;
  // Per-source partial-line carry across feed calls: N sources deliver
  // interleaved byte chunks, and source A's half line must never be
  // completed by source B's next chunk. Source 0 is the legacy single
  // feed's tail.
  std::unordered_map<uint32_t, std::string> tails;
  int last_flush_conflict = 0;  // conflict_start of the last popped gen
  // Serializes every public entry point (see the extern "C" contract
  // below): ctypes releases the GIL for the duration of a foreign
  // call, so a Python reader thread feeding while the classify loop
  // flushes is REAL C++-level concurrency. One uncontended lock per
  // feed/flush (per chunk / per generation, never per record) is noise
  // against the 1 Hz poll cadence; tools/native_sanitize.sh's TSan
  // phase drives concurrent feed/flush to prove the discipline holds.
  std::mutex mu;

  explicit Engine(uint32_t cap, uint32_t mb)
      : capacity(cap), max_batch(mb), slot_fp(cap, 0), slot_used(cap, 0),
        slot_src(cap), slot_dst(cap), slot_source(cap, 0),
        occ_epoch(static_cast<size_t>(cap) * 2, 0),
        occ_bits(static_cast<size_t>(cap) * 2, 0) {}
};

// Python-int-compatible enough for the wire format: optional surrounding
// spaces, optional sign, then digits. Returns false on anything else
// (mirrors the parse_line() int() guard in ingest/protocol.py).
bool parse_i64(const char* s, size_t len, int64_t* out) {
  size_t i = 0, j = len;
  while (i < j && (s[i] == ' ' || s[i] == '\r')) i++;
  while (j > i && (s[j - 1] == ' ' || s[j - 1] == '\r')) j--;
  if (i >= j) return false;
  bool neg = false;
  if (s[i] == '+' || s[i] == '-') {
    neg = s[i] == '-';
    i++;
  }
  if (i >= j) return false;
  int64_t v = 0;
  for (; i < j; i++) {
    if (s[i] < '0' || s[i] > '9') return false;
    int d = s[i] - '0';
    // overflow guard: >19-digit fields would hit signed-overflow UB where
    // Python's arbitrary-precision int parses them; both sides now reject
    if (v > (INT64_MAX - d) / 10) return false;
    v = v * 10 + d;
  }
  *out = neg ? -v : v;
  return true;
}

// Strict UTF-8 validity — the Python oracle's parse_line rejects lines
// whose string fields fail .decode() (ingest/protocol.py), so we must too
// or slot metadata could carry bytes Python can't decode. ASCII fast path
// first: telemetry fields are MACs/ports/datapath ids, almost always pure
// ASCII.
bool utf8_valid(const char* s, size_t len) {
  size_t i = 0;
  // ASCII fast path, 8 bytes at a time: telemetry fields are MACs /
  // datapath ids / port numbers — pure ASCII in practice, so this skim
  // is the whole check. memcpy keeps the load alignment-safe.
  while (i + 8 <= len) {
    uint64_t w;
    std::memcpy(&w, s + i, 8);
    if (w & 0x8080808080808080ULL) break;
    i += 8;
  }
  while (i < len && static_cast<unsigned char>(s[i]) < 0x80) i++;
  while (i < len) {
    unsigned char c = s[i];
    size_t n;
    if (c < 0x80) n = 0;
    else if ((c & 0xE0) == 0xC0) n = 1;
    else if ((c & 0xF0) == 0xE0) n = 2;
    else if ((c & 0xF8) == 0xF0) n = 3;
    else return false;
    if (i + n >= len) return false;  // truncated sequence
    for (size_t k = 1; k <= n; k++) {
      if ((static_cast<unsigned char>(s[i + k]) & 0xC0) != 0x80) return false;
    }
    // reject overlong/surrogate/out-of-range forms
    if (n == 1 && c < 0xC2) return false;
    if (n == 2 && c == 0xE0 && static_cast<unsigned char>(s[i + 1]) < 0xA0)
      return false;
    if (n == 2 && c == 0xED && static_cast<unsigned char>(s[i + 1]) >= 0xA0)
      return false;
    if (n == 3 && c == 0xF0 && static_cast<unsigned char>(s[i + 1]) < 0x90)
      return false;
    if (n == 3 && (c > 0xF4 ||
                   (c == 0xF4 && static_cast<unsigned char>(s[i + 1]) > 0x8F)))
      return false;
    i += n + 1;
  }
  return true;
}

Generation& current_gen(Engine* e) {
  if (e->gens.empty()) {
    // everything previously flushed has been applied by now — the run
    // (the coalescible-uniqueness domain) starts over
    ++e->run_seq;
    e->gens.emplace_back();
  }
  return e->gens.back();
}

void push_row(Engine* e, uint32_t slot, uint8_t is_fwd, uint8_t is_create,
              int32_t time, uint64_t pkts, uint64_t bytes) {
  size_t k = (static_cast<size_t>(slot) << 1) | is_fwd;
  uint8_t bit = is_create ? 1 : 2;
  Generation* g = &current_gen(e);
  uint8_t occ = e->occ_epoch[k] == e->run_seq ? e->occ_bits[k] : 0;
  if ((occ & bit) || g->rows.size() >= e->max_batch) {
    bool conflict = (occ & bit) != 0;
    e->gens.emplace_back();
    g = &e->gens.back();
    g->conflict_start = conflict;
    if (conflict) {
      // new run: this key (and every other) may appear once more
      ++e->run_seq;
      occ = 0;
    }
    // size rollover: SAME run — occupancy stays valid, so a key that
    // already appeared anywhere in the run still conflicts later,
    // keeping whole-run concatenation scatter-safe
  }
  e->occ_epoch[k] = e->run_seq;
  e->occ_bits[k] = occ | bit;
  g->rows.push_back(Row{slot, time, pkts, bytes, is_fwd, is_create});
}

// parse_rec outcomes: noise (no 'data' prefix — Ryu logs/headers, not
// an error), a valid record, or a malformed telemetry line (counted per
// source and skipped — never a crash, never a torn row).
enum ParseResult { kNoise = 0, kValid = 1, kMalformed = 2 };

// Parse one complete line (no trailing \n) without touching engine state.
int parse_rec(const char* line, size_t len, bool eager_rfp, uint32_t source,
              ParsedRec* out) {
  // prefix match, like the reference's line.startswith('data')
  // (traffic_classifier.py:152)
  if (len < 4 || std::memcmp(line, "data", 4) != 0) return kNoise;
  // split on \t, drop field 0, need EXACTLY 8 remaining — the wire
  // format emits exactly 9 columns, so trailing junk fields are a
  // corrupt line, not slop to ignore (and the Python parser rejects
  // identically). memchr (SIMD in libc) instead of a per-byte scan —
  // the split was ~a third of the single-thread parse cost at
  // 56 B/line.
  const char* f[16];
  size_t fl[16];
  int nf = 0;
  size_t start = 0;
  while (nf < 16) {
    const char* t = static_cast<const char*>(
        std::memchr(line + start, '\t', len - start));
    f[nf] = line + start;
    if (t == nullptr) {
      fl[nf] = len - start;
      nf++;
      break;
    }
    fl[nf] = static_cast<size_t>(t - line) - start;
    nf++;
    start = static_cast<size_t>(t - line) + 1;
  }
  if (nf != 9) return kMalformed;
  int64_t time, pkts, bytes;
  if (!parse_i64(f[1], fl[1], &time)) return kMalformed;
  if (!parse_i64(f[7], fl[7], &pkts)) return kMalformed;
  if (!parse_i64(f[8], fl[8], &bytes)) return kMalformed;
  // Cumulative counters can't be negative; a signed value here is a
  // corrupt line (and would otherwise wrap to ~1.8e19 via the uint64_t
  // cast below, diverging from the Python parser, which also rejects).
  if (pkts < 0 || bytes < 0) return kMalformed;
  // the Python oracle decodes datapath/ports/MACs as UTF-8 and rejects
  // the line on failure; match it (fields 2..6 are the string fields)
  for (int k = 2; k <= 6; k++) {
    if (!utf8_valid(f[k], fl[k])) return kMalformed;
  }
  // f[2]=datapath f[4]=eth_src f[5]=eth_dst (f[3]=in_port f[6]=out_port
  // are carried by the wire format but unused for keying, same as the
  // reference)
  out->dp = f[2];
  out->dp_len = static_cast<uint32_t>(fl[2]);
  out->src = f[4];
  out->src_len = static_cast<uint32_t>(fl[4]);
  out->dst = f[5];
  out->dst_len = static_cast<uint32_t>(fl[5]);
  out->time = static_cast<int32_t>(time);
  out->pkts = static_cast<uint64_t>(pkts);
  out->bytes = static_cast<uint64_t>(bytes);
  out->fp = flow_fingerprint(f[2], fl[2], f[4], fl[4], f[5], fl[5], source);
  if (eager_rfp) {
    // worker threads pre-hash the reverse key too: the sequential router
    // then never hashes, only probes
    out->rfp =
        flow_fingerprint(f[2], fl[2], f[5], fl[5], f[4], fl[4], source);
    out->has_rfp = 1;
  } else {
    out->has_rfp = 0;
  }
  return kValid;
}

// Route one parsed record (the FlowIndex.assign logic). MUST run in
// original record order — slot assignment is order-dependent and the
// Python oracle is sequential. ``source`` tags a newly created slot's
// namespace; hits already carry the source in their fingerprint.
void route_rec(Engine* e, const ParsedRec& r, uint32_t source) {
  uint32_t* hit = e->key_to_slot.find(r.fp);
  if (hit != nullptr) {
    push_row(e, *hit, 1, 0, r.time, r.pkts, r.bytes);
  } else {
    uint64_t rfp = r.has_rfp
                       ? r.rfp
                       : flow_fingerprint(r.dp, r.dp_len, r.dst, r.dst_len,
                                          r.src, r.src_len, source);
    hit = e->key_to_slot.find(rfp);
    if (hit != nullptr) {
      push_row(e, *hit, 0, 0, r.time, r.pkts, r.bytes);
    } else {
      uint32_t slot;
      if (!e->free_slots.empty()) {
        slot = e->free_slots.back();
        e->free_slots.pop_back();
      } else if (e->next_slot < e->capacity) {
        slot = e->next_slot++;
      } else {
        e->dropped++;
        e->parsed++;
        if (r.time > e->last_time) e->last_time = r.time;
        return;
      }
      e->key_to_slot.insert(r.fp, slot);
      e->slot_fp[slot] = r.fp;
      e->slot_used[slot] = 1;
      e->slot_src[slot].assign(r.src, r.src_len);
      e->slot_dst[slot].assign(r.dst, r.dst_len);
      e->slot_source[slot] = source;
      push_row(e, slot, 1, 1, r.time, r.pkts, r.bytes);
    }
  }
  e->parsed++;
  if (r.time > e->last_time) e->last_time = r.time;
}

inline void parse_and_route(Engine* e, const char* line, size_t len,
                            uint32_t source, uint64_t* errors) {
  ParsedRec r;
  int res = parse_rec(line, len, /*eager_rfp=*/false, source, &r);
  if (res == kValid) {
    route_rec(e, r, source);
  } else if (res == kMalformed) {
    ++*errors;
  }
}

// Route a parsed block with the key-map probe lines prefetched: at ~1M
// live flows the map (16+ MB) misses cache on nearly every probe, and
// those serialized misses — not parsing — bound the single-thread feed
// (measured: prefix-reject framing runs 57 M lines/s, full routing
// 2.4 M/s). Records carry eager reverse fingerprints so both probe
// targets prefetch; the block is small enough that all its lines stay
// resident in L1/L2 until routed. Routing order stays strictly
// sequential — identical assignment to the unprefetched path. A grow()
// during the block only wastes prefetches (correctness unaffected).
// Shared block size for both feed paths: small enough that every
// prefetched map line stays L1/L2-resident until its record routes.
constexpr size_t kRouteBlock = 64;

inline void route_block(Engine* e, const ParsedRec* recs, size_t n,
                        uint32_t source) {
  const FpMap& m = e->key_to_slot;
  for (size_t i = 0; i < n; i++) {
    size_t b = recs[i].fp & m.mask;
    __builtin_prefetch(&m.vals[b]);
    __builtin_prefetch(&m.keys[b]);
    size_t rb = recs[i].rfp & m.mask;
    __builtin_prefetch(&m.vals[rb]);
    __builtin_prefetch(&m.keys[rb]);
  }
  for (size_t i = 0; i < n; i++) route_rec(e, recs[i], source);
}

// Parse every line in [buf+begin, buf+end) into out (telemetry lines
// only; malformed lines counted into *errors). begin must sit at a line
// start; end at a line end (past '\n'). Runs on worker threads WITHOUT
// the engine lock — it touches no engine state, only its own outputs.
void parse_region(const char* buf, size_t begin, size_t end,
                  uint32_t source, std::vector<ParsedRec>* out,
                  uint64_t* errors) {
  size_t start = begin;
  while (start < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(buf + start, '\n', end - start));
    if (nl == nullptr) break;  // caller guarantees end is past a '\n'
    size_t i = static_cast<size_t>(nl - buf);
    ParsedRec r;
    int res = parse_rec(buf + start, i - start, /*eager_rfp=*/true,
                        source, &r);
    if (res == kValid) {
      out->push_back(r);
    } else if (res == kMalformed) {
      ++*errors;
    }
    start = i + 1;
  }
}

// Threaded feed: split [begin, end) at line boundaries, parse in
// parallel, route sequentially. Only called when end-begin is large and
// the host has >1 core. Returns the malformed-line count.
uint64_t feed_threaded(Engine* e, const char* buf, size_t begin, size_t end,
                       size_t nthreads, uint32_t source) {
  std::vector<size_t> cut(nthreads + 1, begin);
  cut[nthreads] = end;
  size_t span = (end - begin) / nthreads;
  for (size_t t = 1; t < nthreads; t++) {
    size_t c = begin + t * span;
    // never inspect buf[begin-1]: with a tiny forced-thread region span
    // can be 0 and begin can be 0 (late cuts then collapse to empty)
    if (c < begin + 1) c = begin + 1;
    while (c < end && buf[c - 1] != '\n') c++;  // advance to a line start
    cut[t] = c < cut[t - 1] ? cut[t - 1] : c;
  }
  std::vector<std::vector<ParsedRec>> outs(nthreads);
  std::vector<uint64_t> errs(nthreads, 0);
  std::vector<std::thread> workers;
  workers.reserve(nthreads - 1);
  for (size_t t = 1; t < nthreads; t++) {
    workers.emplace_back(parse_region, buf, cut[t], cut[t + 1], source,
                         &outs[t], &errs[t]);
  }
  parse_region(buf, cut[0], cut[1], source, &outs[0], &errs[0]);
  for (auto& w : workers) w.join();
  uint64_t errors = 0;
  for (size_t t = 0; t < nthreads; t++) {
    errors += errs[t];
    const std::vector<ParsedRec>& rs = outs[t];
    for (size_t i = 0; i < rs.size(); i += kRouteBlock) {
      size_t n = rs.size() - i < kRouteBlock ? rs.size() - i : kRouteBlock;
      route_block(e, rs.data() + i, n, source);
    }
  }
  return errors;
}

// Free one slot back to the allocator. Callers hold e->mu.
void release_slot_locked(Engine* e, uint32_t slot) {
  if (slot >= e->capacity || !e->slot_used[slot]) return;
  e->key_to_slot.erase(e->slot_fp[slot]);
  e->slot_used[slot] = 0;
  e->slot_src[slot].clear();
  e->slot_dst[slot].clear();
  // reset the namespace tag: a reused slot must never inherit a dead
  // source's namespace (the next create stamps its own)
  e->slot_source[slot] = 0;
  e->free_slots.push_back(slot);
}

// Feed raw bytes in arbitrary chunks (partial lines are carried over
// per source). Returns the number of telemetry records parsed from this
// chunk. Callers hold e->mu.
uint64_t feed_locked(Engine* e, const char* buf, uint64_t len,
                     uint32_t source) {
  uint64_t before = e->parsed;
  uint64_t errors = 0;
  std::string& tail = e->tails[source];
  size_t begin = 0;
  if (!tail.empty()) {
    // complete the carried partial line first (routes before anything
    // parsed from this chunk — order preserved)
    const char* p = static_cast<const char*>(std::memchr(buf, '\n', len));
    if (p == nullptr) {
      tail.append(buf, len);
      return 0;
    }
    size_t nl = static_cast<size_t>(p - buf);
    tail.append(buf, nl);
    parse_and_route(e, tail.data(), tail.size(), source, &errors);
    tail.clear();
    begin = nl + 1;
  }
  size_t last_nl = len;  // one past the final '\n'
  while (last_nl > begin && buf[last_nl - 1] != '\n') last_nl--;
  if (last_nl > begin) {
    // TC_ENGINE_THREADS overrides both the thread count and the size
    // threshold (testing: forces the threaded path on single-core CI
    // hosts, where it would otherwise never execute).
    static const long forced = [] {
      const char* v = std::getenv("TC_ENGINE_THREADS");
      long n = v != nullptr ? std::atol(v) : 0L;
      return n > 16 ? 16L : n;  // clamp: typo'd values must not fork
                                // thousands of threads in the hot path
    }();
    static const size_t hw = std::thread::hardware_concurrency();
    const size_t nthreads =
        forced > 0 ? static_cast<size_t>(forced) : (hw > 8 ? 8 : hw);
    const size_t threshold = forced > 0 ? 1 : (1u << 21);
    if (nthreads >= 2 && last_nl - begin >= threshold) {
      errors += feed_threaded(e, buf, begin, last_nl, nthreads, source);
    } else {
      // block-parse then route-with-prefetch (see route_block)
      ParsedRec recs[kRouteBlock];
      size_t nr = 0;
      size_t start = begin;
      while (start < last_nl) {
        const char* nl = static_cast<const char*>(
            std::memchr(buf + start, '\n', last_nl - start));
        if (nl == nullptr) break;
        size_t i = static_cast<size_t>(nl - buf);
        int res = parse_rec(buf + start, i - start, /*eager_rfp=*/true,
                            source, &recs[nr]);
        if (res == kValid) {
          if (++nr == kRouteBlock) {
            route_block(e, recs, nr, source);
            nr = 0;
          }
        } else if (res == kMalformed) {
          errors++;
        }
        start = i + 1;
      }
      route_block(e, recs, nr, source);
    }
  }
  if (last_nl < len) tail.append(buf + last_nl, len - last_nl);
  uint64_t n = e->parsed - before;
  // per-source accounting amortized to one map touch per CALL, never
  // per record — the per-record hot loop stays map-free
  if (n) e->src_parsed[source] += n;
  if (errors) {
    e->parse_errors += errors;
    e->src_parse_errors[source] += errors;
  }
  return n;
}

}  // namespace

// Concurrency contract: every function below except tc_engine_create /
// tc_engine_destroy takes the engine mutex, so feed, flush, and the
// bookkeeping queries may be called from different threads
// concurrently. Destruction is the caller's ordering problem (as with
// any handle API): no call may race tc_engine_destroy.
extern "C" {

void* tc_engine_create(uint32_t capacity, uint32_t max_batch) {
  // capacity is bounded below the FpMap sentinel slot values AND below
  // the wire layout's flag bits: tck_flush_wire packs slot | fwd<<31 |
  // create<<30 (and pads with slot == capacity), so any slot touching
  // bit 30 would silently corrupt direction/create semantics. pack_wire
  // raises for the same bound on the Python path — fail loudly here too.
  if (capacity == 0 || max_batch == 0 || capacity >= (1u << 30)) {
    return nullptr;
  }
  return new Engine(capacity, max_batch);
}

void tc_engine_destroy(void* h) { delete static_cast<Engine*>(h); }

// Feed raw bytes in arbitrary chunks (partial lines are carried over).
// Returns the number of telemetry records parsed from this chunk.
// Legacy single-source entry: the default namespace (source 0) —
// bit-for-bit the pre-fan-in behavior.
uint64_t tc_engine_feed(void* h, const char* buf, uint64_t len) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  return feed_locked(e, buf, len, 0);
}

// THE fan-in wire entry: one call per (source, poll batch) — raw pipe /
// capture / synthetic bytes routed entirely in C++ under the source's
// namespace (fingerprints fold the source id; new slots are tagged for
// tck_slots_for_source). Per-source partial-line tails keep framing
// correct across interleaved multi-source chunks. Malformed telemetry
// lines ('data' prefix, invalid body) are counted per source and
// skipped — never a crash, never a torn row.
uint64_t tck_feed_lines(void* h, const char* buf, uint64_t len,
                        uint32_t source) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  return feed_locked(e, buf, len, source);
}

uint64_t tc_engine_pending(void* h) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> guard(e->mu);
  uint64_t n = 0;
  for (const auto& g : e->gens) n += g.rows.size();
  return n;
}

// Pop the oldest generation into caller-provided arrays (each sized >=
// max_batch). Returns the row count, 0 when nothing is pending. pkts/bytes
// are split into low-32-bits + float32 lanes, matching the device table's
// uint32+f32 counter representation (core/flow_table.py).
uint32_t tc_engine_flush(void* h, int32_t* slot, int32_t* time,
                         uint32_t* pkts_lo, float* pkts_f, uint32_t* bytes_lo,
                         float* bytes_f, uint8_t* is_fwd, uint8_t* is_create) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> guard(e->mu);
  while (!e->gens.empty() && e->gens.front().rows.empty()) {
    e->gens.pop_front();
  }
  if (e->gens.empty()) return 0;
  const Generation& g = e->gens.front();
  e->last_flush_conflict = g.conflict_start ? 1 : 0;
  uint32_t n = static_cast<uint32_t>(g.rows.size());
  for (uint32_t i = 0; i < n; i++) {
    const Row& r = g.rows[i];
    slot[i] = static_cast<int32_t>(r.slot);
    time[i] = r.time;
    pkts_lo[i] = static_cast<uint32_t>(r.pkts & 0xFFFFFFFFu);
    pkts_f[i] = static_cast<float>(r.pkts);
    bytes_lo[i] = static_cast<uint32_t>(r.bytes & 0xFFFFFFFFu);
    bytes_f[i] = static_cast<float>(r.bytes);
    is_fwd[i] = r.is_fwd;
    is_create[i] = r.is_create;
  }
  e->gens.pop_front();
  return n;
}

// 1 iff the generation most recently popped by tc_engine_flush was
// started by a same-(slot, direction, kind) conflict with its
// predecessor — i.e. it must NOT be coalesced into the same device
// scatter as the batch flushed before it. 0 for size-rollover
// generations and the first generation of a drain.
int tc_engine_last_flush_conflict(void* h) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  return e->last_flush_conflict;
}

// Pop the oldest generation DIRECTLY into the packed uint32 wire layout
// (core/flow_table.pack_wire): one pass from the C++ rows into the
// caller's pinned staging buffer, zero per-flush numpy allocation or
// Python column work. ``wire`` must hold >= max_batch*6 uint32; rows
// are written TIGHT at the chosen width (4 compact / 6 full), padded
// with pad_slot rows (is_fwd set, everything else zero — exactly
// pack_wire's padding) up to the smallest admitting bucket from
// ``buckets`` (ascending, last entry >= max_batch). Returns
// (width << 32) | padded_rows, or 0 when nothing is pending. The width
// rule matches pack_wire bit-for-bit: compact whenever every counter's
// float32 image is < 2^31, so the device-side unpack reconstructs
// identical f32 lanes.
uint64_t tck_flush_wire(void* h, uint32_t* wire, const uint32_t* buckets,
                        uint32_t n_buckets, uint32_t pad_slot) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> guard(e->mu);
  while (!e->gens.empty() && e->gens.front().rows.empty()) {
    e->gens.pop_front();
  }
  if (e->gens.empty() || n_buckets == 0) return 0;
  const Generation& g = e->gens.front();
  e->last_flush_conflict = g.conflict_start ? 1 : 0;
  const uint32_t n = static_cast<uint32_t>(g.rows.size());
  constexpr float kLim = 2147483648.0f;  // 2^31 as float32
  bool compact = true;
  for (uint32_t i = 0; i < n; i++) {
    const Row& r = g.rows[i];
    if (static_cast<float>(r.pkts) >= kLim ||
        static_cast<float>(r.bytes) >= kLim) {
      compact = false;
      break;
    }
  }
  uint32_t padded = buckets[n_buckets - 1];
  for (uint32_t b = 0; b < n_buckets; b++) {
    if (n <= buckets[b]) {
      padded = buckets[b];
      break;
    }
  }
  const uint32_t w = compact ? 4 : 6;
  for (uint32_t i = 0; i < n; i++) {
    const Row& r = g.rows[i];
    uint32_t* row = wire + static_cast<size_t>(i) * w;
    row[0] = r.slot | (static_cast<uint32_t>(r.is_fwd) << 31) |
             (static_cast<uint32_t>(r.is_create) << 30);
    row[1] = static_cast<uint32_t>(r.time);
    row[2] = static_cast<uint32_t>(r.pkts & 0xFFFFFFFFu);
    if (compact) {
      row[3] = static_cast<uint32_t>(r.bytes & 0xFFFFFFFFu);
    } else {
      float pf = static_cast<float>(r.pkts);
      float bf = static_cast<float>(r.bytes);
      std::memcpy(&row[3], &pf, 4);
      row[4] = static_cast<uint32_t>(r.bytes & 0xFFFFFFFFu);
      std::memcpy(&row[5], &bf, 4);
    }
  }
  // padding rows: scratch slot with the fwd flag, zeros elsewhere — a
  // clean no-op under apply_wire, bit-identical to pack_wire's pad
  const uint32_t pad0 = pad_slot | (1u << 31);
  for (uint32_t i = n; i < padded; i++) {
    uint32_t* row = wire + static_cast<size_t>(i) * w;
    row[0] = pad0;
    std::memset(row + 1, 0, (w - 1) * sizeof(uint32_t));
  }
  e->gens.pop_front();
  return (static_cast<uint64_t>(w) << 32) | padded;
}

// Every in-use slot in ``source``'s namespace, ascending — the native
// half of FlowStateEngine.evict_source (the caller clears the device
// rows, then releases these slots in bulk). O(capacity) scan, but only
// walked on a source-death event, never per tick — the same contract
// as FlowIndex.slots_for_source. ``out`` must hold >= capacity slots.
uint32_t tck_slots_for_source(void* h, uint32_t source, uint32_t* out) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  uint32_t n = 0;
  for (uint32_t s = 0; s < e->capacity; s++) {
    if (e->slot_used[s] && e->slot_source[s] == source) out[n++] = s;
  }
  return n;
}

// Drop ``source``'s carried partial line — the native half of
// FlowStateEngine.evict_source's framing reset. The dead incarnation's
// dangling fragment must not be completed by a restarted stream's
// first chunk (the fan-in queue's \x00\n poison seam guards the same
// boundary from the delivery side; this guards direct engine callers).
void tck_reset_tail(void* h, uint32_t source) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  e->tails.erase(source);
}

// Malformed-telemetry accounting ('data'-prefixed lines that failed the
// parse — noise lines are not errors), total and per source.
uint64_t tck_parse_errors_total(void* h) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  return e->parse_errors;
}

uint64_t tck_parse_errors(void* h, uint32_t source) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  auto it = e->src_parse_errors.find(source);
  return it == e->src_parse_errors.end() ? 0 : it->second;
}

uint64_t tck_source_parsed(void* h, uint32_t source) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  auto it = e->src_parsed.find(source);
  return it == e->src_parsed.end() ? 0 : it->second;
}

uint64_t tc_engine_dropped(void* h) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  return e->dropped;
}
uint64_t tc_engine_parsed(void* h) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  return e->parsed;
}
int32_t tc_engine_last_time(void* h) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  return e->last_time;
}

uint32_t tc_engine_num_flows(void* h) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  return static_cast<uint32_t>(e->key_to_slot.used);
}

// Copy the (src, dst) MAC strings for a slot into caller buffers of size
// cap (NUL-terminated, truncated if needed). Returns 1 if the slot is in
// use, 0 otherwise.
int tc_engine_slot_meta(void* h, uint32_t slot, char* src_out, char* dst_out,
                        uint32_t cap) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (slot >= e->capacity || !e->slot_used[slot] || cap == 0) return 0;
  std::snprintf(src_out, cap, "%s", e->slot_src[slot].c_str());
  std::snprintf(dst_out, cap, "%s", e->slot_dst[slot].c_str());
  return 1;
}

// Free a slot (idle eviction). The caller must drain flush() first so no
// pending row can scatter into a reassigned slot — same contract as
// FlowStateEngine.evict_idle.
void tc_engine_release_slot(void* h, uint32_t slot) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  release_slot_locked(e, slot);
}

// Bulk release: one ctypes crossing for an eviction batch instead of one
// per slot — an idle-storm at the 2^20-flow scale releases hundreds of
// thousands of slots in one tick.
void tc_engine_release_slots(void* h, const uint32_t* slots, uint32_t n) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  for (uint32_t i = 0; i < n; ++i) release_slot_locked(e, slots[i]);
}

// --- serving-state checkpoint support --------------------------------------
// Export the index for a warm-restart checkpoint: per-slot fingerprints +
// occupancy (metadata strings travel via tc_engine_slot_meta). Returns
// next_slot — the sequential-assignment frontier a restore must resume.
uint32_t tc_engine_export_index(void* h, uint64_t* fp_out, uint8_t* used_out) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  std::memcpy(fp_out, e->slot_fp.data(),
              static_cast<size_t>(e->capacity) * sizeof(uint64_t));
  std::memcpy(used_out, e->slot_used.data(), e->capacity);
  return e->next_slot;
}

// Export the free-slot stack VERBATIM (bottom to top): allocation order
// is LIFO, so a warm restart must preserve the exact stack for the
// restored engine's future slot assignments to match a never-stopped one.
uint32_t tc_engine_export_free(void* h, uint32_t* out) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  std::memcpy(out, e->free_slots.data(),
              e->free_slots.size() * sizeof(uint32_t));
  return static_cast<uint32_t>(e->free_slots.size());
}

// Bulk import into a FRESH engine of the same capacity: slots +
// fingerprints + fixed 64-byte src/dst cells, ONE ctypes crossing for
// the whole table (per-slot crossings would stall a 2^20-flow restart).
void tc_engine_import_slots(void* h, const uint32_t* slots,
                            const uint64_t* fps, const char* src,
                            const char* dst, uint32_t n) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t s = slots[i];
    if (s >= e->capacity || e->slot_used[s]) continue;
    e->slot_fp[s] = fps[i];
    e->slot_used[s] = 1;
    // Cells are fixed 64-byte numpy 'S64' fields with NO guaranteed NUL
    // terminator when the string fills the cell — bound the read.
    const char* sp = src + static_cast<size_t>(i) * 64;
    const char* dp = dst + static_cast<size_t>(i) * 64;
    e->slot_src[s].assign(sp, strnlen(sp, 64));
    e->slot_dst[s].assign(dp, strnlen(dp, 64));
    e->key_to_slot.insert(fps[i], s);
  }
}

// Finish an import: restore the assignment frontier, the eviction clock,
// and the free stack verbatim.
void tc_engine_import_finish(void* h, uint32_t next_slot, int32_t last_time,
                             const uint32_t* free_list, uint32_t n_free) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  e->next_slot = next_slot;
  e->last_time = last_time;
  e->free_slots.assign(free_list, free_list + n_free);
}

// Bulk metadata export: fixed 64-byte NUL-terminated cells per string —
// the one-crossing counterpart of tc_engine_slot_meta for checkpoints.
void tc_engine_export_meta(void* h, const uint32_t* slots, uint32_t n,
                           char* src_out, char* dst_out) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t s = slots[i];
    char* so = src_out + static_cast<size_t>(i) * 64;
    char* to = dst_out + static_cast<size_t>(i) * 64;
    if (s < e->capacity && e->slot_used[s]) {
      std::snprintf(so, 64, "%s", e->slot_src[s].c_str());
      std::snprintf(to, 64, "%s", e->slot_dst[s].c_str());
    } else {
      so[0] = to[0] = '\0';
    }
  }
}

}  // extern "C"
