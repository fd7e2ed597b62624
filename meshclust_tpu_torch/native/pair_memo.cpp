// Align mode's identity memo: pair key -> identity, an open-addressing hash
// table (see utils/pair_memo.py, the reference's Feature::align atable,
// Feature.cpp:222-243).
//
//   - key: int64 lo * n + hi (never negative); value: float64; -1 marks an
//     empty slot;
//   - slot = splitmix64 finaliser of the key, masked to a power-of-two
//     capacity; collisions probe linearly;
//   - before a batch is inserted the table doubles until the batch, were
//     every key new, would leave it at most half full, so an insert never
//     moves the table mid-batch and probes stay short;
//   - a key already present, or repeated within a batch, keeps the first
//     value it was given (the sorted-array memo it replaces found the first
//     of equal keys).
//
// C ABI, one call a batch:
//   mc_memo_new() -> handle (null when out of memory)   mc_memo_free(h)
//   mc_memo_insert(h, keys[k], vals[k], k) -> keys added, -1 for a negative
//     key (nothing inserted), -2 out of memory (nothing inserted)
//   mc_memo_lookup(h, keys[k], k, out_vals[k], out_found[k]) -> keys found;
//     out_vals is 0 where a key is absent
//   mc_memo_size(h)   mc_memo_export(h, keys_out[size], vals_out[size]) in
//   slot order   mc_memo_live() -> tables allocated and not yet freed
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <new>

namespace {

constexpr int64_t kEmpty = -1;
constexpr uint64_t kMinCap = 1024;
// keys a batch probe prefetches ahead: the table outgrows the caches, so
// each probe is a memory read that overlaps with the next ones
constexpr int64_t kAhead = 16;

struct Slot {
  int64_t key;
  double val;
};

struct Table {
  Slot* slots;
  uint64_t mask;  // capacity - 1
  int64_t size;
};

std::atomic<int64_t> g_live{0};

inline uint64_t mix(uint64_t x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return x;
}

Slot* alloc_slots(uint64_t cap) {
  Slot* s = static_cast<Slot*>(std::malloc(cap * sizeof(Slot)));
  if (s == nullptr) return nullptr;
  for (uint64_t i = 0; i < cap; i++) s[i].key = kEmpty;
  return s;
}

// Capacity for `need` keys at a load of at most one half; false when out of
// memory (the table is then as it was).
bool reserve(Table* t, uint64_t need) {
  uint64_t cap = t->mask + 1;
  if (need <= cap / 2) return true;
  uint64_t ncap = cap;
  while (need > ncap / 2) ncap <<= 1;
  Slot* ns = alloc_slots(ncap);
  if (ns == nullptr) return false;
  const uint64_t nmask = ncap - 1;
  for (uint64_t i = 0; i < cap; i++) {
    const Slot& s = t->slots[i];
    if (s.key == kEmpty) continue;
    uint64_t j = mix(static_cast<uint64_t>(s.key)) & nmask;
    while (ns[j].key != kEmpty) j = (j + 1) & nmask;
    ns[j] = s;
  }
  std::free(t->slots);
  t->slots = ns;
  t->mask = nmask;
  return true;
}

}  // namespace

extern "C" {

void* mc_memo_new() {
  Table* t = new (std::nothrow) Table;
  if (t == nullptr) return nullptr;
  t->slots = alloc_slots(kMinCap);
  if (t->slots == nullptr) {
    delete t;
    return nullptr;
  }
  t->mask = kMinCap - 1;
  t->size = 0;
  g_live.fetch_add(1);
  return t;
}

void mc_memo_free(void* h) {
  if (h == nullptr) return;
  Table* t = static_cast<Table*>(h);
  std::free(t->slots);
  delete t;
  g_live.fetch_sub(1);
}

int64_t mc_memo_live() { return g_live.load(); }

int64_t mc_memo_size(const void* h) {
  return static_cast<const Table*>(h)->size;
}

int64_t mc_memo_insert(void* h, const int64_t* keys, const double* vals,
                       int64_t k) {
  Table* t = static_cast<Table*>(h);
  for (int64_t q = 0; q < k; q++)
    if (keys[q] < 0) return -1;
  if (!reserve(t, static_cast<uint64_t>(t->size + k))) return -2;
  Slot* slots = t->slots;
  const uint64_t mask = t->mask;
  int64_t added = 0;
  for (int64_t q = 0; q < k; q++) {
    if (q + kAhead < k)
      __builtin_prefetch(
          &slots[mix(static_cast<uint64_t>(keys[q + kAhead])) & mask]);
    const int64_t key = keys[q];
    uint64_t i = mix(static_cast<uint64_t>(key)) & mask;
    for (;;) {
      const int64_t s = slots[i].key;
      if (s == key) break;
      if (s == kEmpty) {
        slots[i].key = key;
        slots[i].val = vals[q];
        added++;
        break;
      }
      i = (i + 1) & mask;
    }
  }
  t->size += added;
  return added;
}

int64_t mc_memo_lookup(const void* h, const int64_t* keys, int64_t k,
                       double* out_vals, uint8_t* out_found) {
  const Table* t = static_cast<const Table*>(h);
  const Slot* slots = t->slots;
  const uint64_t mask = t->mask;
  int64_t hits = 0;
  for (int64_t q = 0; q < k; q++) {
    if (q + kAhead < k)
      __builtin_prefetch(
          &slots[mix(static_cast<uint64_t>(keys[q + kAhead])) & mask]);
    const int64_t key = keys[q];
    out_vals[q] = 0.0;
    out_found[q] = 0;
    if (key < 0) continue;
    uint64_t i = mix(static_cast<uint64_t>(key)) & mask;
    for (;;) {
      const int64_t s = slots[i].key;
      if (s == key) {
        out_vals[q] = slots[i].val;
        out_found[q] = 1;
        hits++;
        break;
      }
      if (s == kEmpty) break;
      i = (i + 1) & mask;
    }
  }
  return hits;
}

void mc_memo_export(const void* h, int64_t* keys_out, double* vals_out) {
  const Table* t = static_cast<const Table*>(h);
  int64_t o = 0;
  for (uint64_t i = 0; i <= t->mask; i++) {
    if (t->slots[i].key == kEmpty) continue;
    keys_out[o] = t->slots[i].key;
    vals_out[o] = t->slots[i].val;
    o++;
  }
}

}  // extern "C"
