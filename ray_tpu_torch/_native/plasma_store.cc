// rtpu plasma: node-local shared-memory immutable object store.
//
// TPU-native counterpart of the reference's plasma store
// (reference: src/ray/object_manager/plasma/store.h, dlmalloc.cc): one POSIX
// shared-memory arena per node, a first-fit free-list allocator with
// coalescing, and an open-addressing object table — all resident *inside* the
// shared segment so every process (raylet, workers, drivers) maps the same
// memory and reads sealed objects with zero copies. Unlike the reference
// there is no store server socket protocol or fd-passing: clients attach to
// the named segment directly and synchronize through a robust process-shared
// mutex; the raylet remains the control-plane authority (eviction policy,
// spill decisions) but the data path is pure shared memory.
//
// Object lifecycle: CREATE (allocate, writer fills bytes) -> SEAL (immutable,
// readable by all) -> [GET pins / RELEASE unpins] -> DELETE or LRU-EVICT.
//
// Exposed as a flat C ABI consumed from Python via ctypes
// (ray_tpu_torch/_native/plasma.py).

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <unordered_map>
#include <unordered_set>

namespace {

constexpr uint64_t kMagic = 0x52545055504c4153ULL;  // "RTPUPLAS"
constexpr uint32_t kIdSize = 20;
constexpr uint32_t kTableSize = 1 << 16;  // max objects per node store
constexpr uint64_t kAlign = 64;
constexpr uint32_t kStateFree = 0;
constexpr uint32_t kStateCreated = 1;
constexpr uint32_t kStateSealed = 2;
constexpr uint32_t kStateTombstone = 3;

struct Entry {
  uint8_t id[kIdSize];
  uint32_t state;
  uint64_t offset;     // data offset from arena base
  uint64_t data_size;  // usable bytes
  int32_t pin_count;   // readers currently mapping the object
  uint32_t pending_delete;  // freed by owner; reclaim when pin_count drops to 0
  uint64_t lru_tick;   // last touch, for eviction ordering
};

// Free/used block header living immediately before each data region.
// Padded to kAlign (64) so that data offsets — which sit sizeof(Block) past
// an aligned boundary — are themselves 64-byte aligned end-to-end (zero-copy
// numpy views and future DMA mappings rely on this).
struct Block {
  uint64_t size;       // total block size including header
  uint64_t prev_size;  // size of physically-previous block (0 if first)
  uint32_t free;
  uint32_t _pad;
  uint64_t next_free;  // offset of next free block (0 = none); valid if free
  uint64_t prev_free;  // offset of prev free block
  uint64_t _pad2[3];   // pad header to 64 bytes
};
static_assert(sizeof(Block) == kAlign, "Block header must equal kAlign");

struct Header {
  uint64_t magic;
  uint64_t capacity;    // arena bytes (data region)
  uint64_t arena_off;   // offset of arena base from segment start
  uint64_t used;        // bytes allocated (incl. headers)
  uint64_t num_objects;
  uint64_t lru_clock;
  uint64_t free_head;   // offset of first free block (0 = none)
  uint64_t evicted_bytes;
  uint64_t evicted_count;
  uint64_t poisoned;        // structural corruption detected; all ops fail
  uint64_t recovered_count; // successful free-list rebuilds after owner death
  pthread_mutex_t mutex;
  Entry table[kTableSize];
};

struct Store {
  Header* hdr;
  uint8_t* base;  // segment base
  uint64_t map_size;
};

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

inline Block* block_at(Store* s, uint64_t off) {
  return reinterpret_cast<Block*>(s->base + s->hdr->arena_off + off - sizeof(Block));
}

// Block bookkeeping uses "data offsets": offset of the data region within the
// arena; the header sits sizeof(Block) before it. Offset 0 is reserved (null).

inline uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 20-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdSize; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

// A process died while holding the mutex, possibly mid-way through a
// multi-step mutation (arena_alloc split, arena_free splice, create/delete
// entry update). The block headers (size/free flags) are single-word writes
// updated before any list pointers, so the physical chain of blocks is still
// walkable — rebuild the free list, reconcile the entry table against it,
// and recompute the counters. Returns 0 on success, -1 if the chain itself
// is corrupt (then the store must be poisoned, not silently reused).
int rebuild_after_owner_death(Store* s) {
  Header* h = s->hdr;
  const uint64_t kMaxBlocks = kTableSize * 4ULL;

  // Pass 1: validate that blocks tile the arena exactly. ps_open aligns
  // capacity to kAlign and every allocation is align_up'd, so all sizes must
  // be kAlign multiples — a stale-payload "header" mid-split rarely is.
  uint64_t off = sizeof(Block);
  uint64_t prev_size = 0;
  uint64_t walked = 0;
  while (off - sizeof(Block) < h->capacity) {
    Block* b = block_at(s, off);
    if (b->size < sizeof(Block) || b->size % kAlign != 0 || b->free > 1 ||
        off - sizeof(Block) + b->size > h->capacity)
      return -1;
    b->prev_size = prev_size;  // repairable from the walk; fix unconditionally
    prev_size = b->size;
    off += b->size;
    if (++walked > kMaxBlocks) return -1;
  }
  if (off - sizeof(Block) != h->capacity) return -1;

  // Pass 2: reconcile the entry table. An entry is live only if it points at
  // the start of a used block big enough to hold it (a crash between
  // arena_free and the tombstone write in ps_delete/ps_abort, or mid-create,
  // leaves entries referencing free space — ps_get must never see those).
  // Process-local index of used blocks keeps this O(entries + blocks).
  std::unordered_map<uint64_t, uint64_t> used_blocks;  // data off -> block size
  for (uint64_t boff = sizeof(Block); boff - sizeof(Block) < h->capacity;) {
    Block* b = block_at(s, boff);
    if (!b->free) used_blocks.emplace(boff, b->size);
    boff += b->size;
  }
  uint64_t num_objects = 0;
  std::unordered_set<uint64_t> referenced;
  for (uint32_t i = 0; i < kTableSize; i++) {
    Entry* e = &h->table[i];
    if (e->state != kStateCreated && e->state != kStateSealed) continue;
    auto it = used_blocks.find(e->offset);
    if (it != used_blocks.end() &&
        it->second - sizeof(Block) >= e->data_size) {
      num_objects++;
      referenced.insert(e->offset);
    } else {
      e->state = kStateTombstone;
    }
  }

  // Pass 3: reclaim orphaned used blocks (allocated, but no entry references
  // them — a crash between arena_alloc and the entry write in ps_create, or
  // a half-finished split's tail).
  for (const auto& kv : used_blocks) {
    if (referenced.find(kv.first) == referenced.end())
      block_at(s, kv.first)->free = 1;
  }

  // Pass 4: rebuild the free list (coalescing adjacent frees) + counters.
  h->free_head = 0;
  uint64_t used = 0;
  uint64_t tail_free = 0;  // trailing free run start, for coalescing
  for (uint64_t boff = sizeof(Block); boff - sizeof(Block) < h->capacity;) {
    Block* b = block_at(s, boff);
    uint64_t bsize = b->size;
    if (b->free) {
      if (tail_free) {
        Block* tf = block_at(s, tail_free);
        tf->size += bsize;
        Block* after = block_at(s, boff + bsize);
        if (boff + bsize - sizeof(Block) < h->capacity)
          after->prev_size = tf->size;
      } else {
        tail_free = boff;
      }
    } else {
      if (tail_free) {
        Block* tf = block_at(s, tail_free);
        tf->next_free = h->free_head;
        tf->prev_free = 0;
        if (h->free_head) block_at(s, h->free_head)->prev_free = tail_free;
        h->free_head = tail_free;
        tail_free = 0;
      }
      b->next_free = b->prev_free = 0;
      used += bsize;
    }
    boff += bsize;
  }
  if (tail_free) {
    Block* tf = block_at(s, tail_free);
    tf->next_free = h->free_head;
    tf->prev_free = 0;
    if (h->free_head) block_at(s, h->free_head)->prev_free = tail_free;
    h->free_head = tail_free;
  }
  h->used = used;
  h->num_objects = num_objects;
  h->recovered_count++;
  return 0;
}

// Returns 0 when the lock is held and the store is usable; nonzero otherwise.
int lock(Store* s) {
  int rc = pthread_mutex_lock(&s->hdr->mutex);
  if (rc == EOWNERDEAD) {
    // A crashed process held the lock: the shared structures may be
    // half-mutated. Recover what is provably recoverable; otherwise poison
    // the store so every client fails loudly instead of corrupting data.
    pthread_mutex_consistent(&s->hdr->mutex);
    if (rebuild_after_owner_death(s) != 0) s->hdr->poisoned = 1;
  } else if (rc != 0) {
    return rc;
  }
  if (s->hdr->poisoned) {
    pthread_mutex_unlock(&s->hdr->mutex);
    return -1;
  }
  return 0;
}

void unlock(Store* s) { pthread_mutex_unlock(&s->hdr->mutex); }

Entry* find_entry(Store* s, const uint8_t* id) {
  uint64_t h = hash_id(id) % kTableSize;
  for (uint32_t probe = 0; probe < kTableSize; probe++) {
    Entry* e = &s->hdr->table[(h + probe) % kTableSize];
    if (e->state == kStateFree) return nullptr;
    if (e->state != kStateTombstone && memcmp(e->id, id, kIdSize) == 0) return e;
  }
  return nullptr;
}

Entry* find_slot(Store* s, const uint8_t* id) {
  uint64_t h = hash_id(id) % kTableSize;
  Entry* first_tomb = nullptr;
  for (uint32_t probe = 0; probe < kTableSize; probe++) {
    Entry* e = &s->hdr->table[(h + probe) % kTableSize];
    if (e->state == kStateFree) return first_tomb ? first_tomb : e;
    if (e->state == kStateTombstone) {
      if (!first_tomb) first_tomb = e;
    } else if (memcmp(e->id, id, kIdSize) == 0) {
      return e;  // caller checks state
    }
  }
  return first_tomb;
}

// ---- free-list allocator --------------------------------------------------

void freelist_remove(Store* s, Block* b, uint64_t off) {
  Header* h = s->hdr;
  if (b->prev_free)
    block_at(s, b->prev_free)->next_free = b->next_free;
  else
    h->free_head = b->next_free;
  if (b->next_free) block_at(s, b->next_free)->prev_free = b->prev_free;
  b->free = 0;
  b->next_free = b->prev_free = 0;
}

void freelist_push(Store* s, Block* b, uint64_t off) {
  Header* h = s->hdr;
  b->free = 1;
  b->next_free = h->free_head;
  b->prev_free = 0;
  if (h->free_head) block_at(s, h->free_head)->prev_free = off;
  h->free_head = off;
}

inline uint64_t block_off(Store* s, Block* b) {
  return reinterpret_cast<uint8_t*>(b) + sizeof(Block) - (s->base + s->hdr->arena_off);
}

// Allocate a data region of `size` bytes; returns data offset or 0 on OOM.
uint64_t arena_alloc(Store* s, uint64_t size) {
  Header* h = s->hdr;
  uint64_t need = align_up(size + sizeof(Block));
  uint64_t off = h->free_head;
  while (off) {
    Block* b = block_at(s, off);
    if (b->size >= need) {
      freelist_remove(s, b, off);
      uint64_t leftover = b->size - need;
      if (leftover >= sizeof(Block) + kAlign) {
        // split: carve the tail into a new free block. Write the tail header
        // fully BEFORE shrinking b->size: owner-death recovery walks blocks
        // by size, so at every intermediate crash point the chain must tile
        // the arena (old b->size hides the half-written tail; new b->size
        // exposes an already-valid tail header).
        uint64_t tail_off = off + need;  // data offsets advance with block size
        Block* tail = block_at(s, tail_off);
        tail->size = leftover;
        tail->prev_size = need;
        tail->free = 0;  // orphan-used until pushed; recovery reclaims it
        tail->next_free = tail->prev_free = 0;
        std::atomic_thread_fence(std::memory_order_release);
        b->size = need;
        uint64_t after_off = tail_off + leftover;
        Block* ab = block_at(s, after_off);
        if (reinterpret_cast<uint8_t*>(ab) < s->base + h->arena_off + h->capacity)
          ab->prev_size = leftover;
        freelist_push(s, tail, tail_off);
      }
      h->used += b->size;
      return off;
    }
    off = b->next_free;
  }
  return 0;
}

void arena_free(Store* s, uint64_t off) {
  Header* h = s->hdr;
  Block* b = block_at(s, off);
  h->used -= b->size;
  // coalesce with physically-next block if free
  uint64_t next_off = off + b->size;
  Block* nb = block_at(s, next_off);
  if (reinterpret_cast<uint8_t*>(nb) < s->base + h->arena_off + h->capacity &&
      nb->free) {
    freelist_remove(s, nb, next_off);
    b->size += nb->size;
  }
  // coalesce with physically-previous block if free
  if (b->prev_size) {
    uint64_t prev_off = off - b->prev_size;
    Block* pb = block_at(s, prev_off);
    if (pb->free) {
      freelist_remove(s, pb, prev_off);
      pb->size += b->size;
      b = pb;
      off = prev_off;
    }
  }
  // fix next block's prev_size after coalescing
  uint64_t after_off = off + b->size;
  Block* ab = block_at(s, after_off);
  if (reinterpret_cast<uint8_t*>(ab) < s->base + h->arena_off + h->capacity) {
    ab->prev_size = b->size;
  }
  freelist_push(s, b, off);
}

// Evict least-recently-used unpinned sealed objects until `bytes` are free-able.
// Returns bytes actually freed. Caller holds the lock.
uint64_t evict_lru(Store* s, uint64_t bytes) {
  Header* h = s->hdr;
  uint64_t freed = 0;
  while (freed < bytes) {
    Entry* victim = nullptr;
    for (uint32_t i = 0; i < kTableSize; i++) {
      Entry* e = &h->table[i];
      if (e->state == kStateSealed && e->pin_count == 0) {
        if (!victim || e->lru_tick < victim->lru_tick) victim = e;
      }
    }
    if (!victim) break;
    freed += victim->data_size;
    h->evicted_bytes += victim->data_size;
    h->evicted_count += 1;
    arena_free(s, victim->offset);
    victim->state = kStateTombstone;
    h->num_objects--;
  }
  return freed;
}

}  // namespace

extern "C" {

// Status codes shared with the Python binding.
enum {
  PS_OK = 0,
  PS_NOT_FOUND = 1,
  PS_EXISTS = 2,
  PS_OOM = 3,
  PS_NOT_SEALED = 4,
  PS_PINNED = 5,
  PS_ERROR = 6,
};

// Contract: at most one process per node creates a given store name (the
// raylet); other processes attach with create=0. The stillborn-unlink below
// is only safe under that contract — it reclaims a name whose creator died
// mid-init, and would misfire only if a *live* creator stalled >10 s between
// ftruncate and publishing the magic word.
void* ps_open(const char* name, uint64_t capacity, int create) {
  // Two attempts: if attempt 1 finds a stillborn segment (a creator died
  // between shm_open and publishing the magic word), unlink it and retry the
  // exclusive create so the name is not wedged forever.
  for (int attempt = 0; attempt < 2; attempt++) {
    uint64_t map_size = sizeof(Header) + capacity + kAlign;
    bool init = false;
    int fd = -1;
    if (create) {
      // O_EXCL picks exactly one initializer: concurrent creators that lose
      // the race fall through to the attach path and wait for the magic word,
      // so the header/mutex/free-list are written by a single process.
      fd = shm_open(name, O_RDWR | O_CREAT | O_EXCL, 0600);
      if (fd >= 0) {
        if (ftruncate(fd, map_size) != 0) {
          close(fd);
          shm_unlink(name);
          return nullptr;
        }
        init = true;
      } else if (errno != EEXIST) {
        return nullptr;
      }
    }
    if (fd < 0) {
      fd = shm_open(name, O_RDWR, 0600);
      if (fd < 0) {
        if (create && errno == ENOENT) continue;  // creator unlinked; retry
        return nullptr;
      }
      // The winning creator may not have ftruncate'd yet; wait for the size.
      struct stat st;
      st.st_size = 0;
      for (int i = 0; i < 10000; i++) {
        if (fstat(fd, &st) != 0) {
          close(fd);
          return nullptr;
        }
        if (st.st_size > 0) break;
        usleep(1000);
      }
      if (st.st_size == 0) {
        close(fd);
        if (create) {
          shm_unlink(name);  // stillborn: creator died pre-ftruncate
          continue;
        }
        return nullptr;
      }
      map_size = st.st_size;
    }
    void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    close(fd);
    if (mem == MAP_FAILED) return nullptr;
    Store* s = new Store();
    s->base = static_cast<uint8_t*>(mem);
    s->hdr = static_cast<Header*>(mem);
    s->map_size = map_size;
    if (init) {
      Header* h = s->hdr;
      memset(h, 0, sizeof(Header));
      // Align capacity down to kAlign so every block size is a kAlign
      // multiple — rebuild_after_owner_death relies on this invariant.
      h->capacity = (map_size - sizeof(Header) - kAlign) & ~(kAlign - 1);
      h->arena_off = align_up(sizeof(Header));
      pthread_mutexattr_t attr;
      pthread_mutexattr_init(&attr);
      pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
      pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
      pthread_mutex_init(&h->mutex, &attr);
      // one giant free block spanning the arena; data offset starts after one
      // header
      uint64_t first_off = sizeof(Block);
      Block* b = block_at(s, first_off);
      b->size = h->capacity;
      b->prev_size = 0;
      b->free = 0;
      b->next_free = b->prev_free = 0;
      freelist_push(s, b, first_off);
      std::atomic_thread_fence(std::memory_order_seq_cst);
      h->magic = kMagic;
    } else {
      // wait for creator to finish init
      for (int i = 0; i < 10000 && s->hdr->magic != kMagic; i++) usleep(1000);
      if (s->hdr->magic != kMagic) {
        munmap(mem, map_size);
        delete s;
        if (create) {
          shm_unlink(name);  // stillborn: creator died pre-magic
          continue;
        }
        return nullptr;
      }
    }
    return s;
  }
  return nullptr;
}

void ps_close(void* handle) {
  Store* s = static_cast<Store*>(handle);
  munmap(s->base, s->map_size);
  delete s;
}

void ps_unlink(const char* name) { shm_unlink(name); }

uint8_t* ps_base(void* handle) {
  Store* s = static_cast<Store*>(handle);
  return s->base + s->hdr->arena_off;
}

uint64_t ps_capacity(void* handle) {
  return static_cast<Store*>(handle)->hdr->capacity;
}

// Byte offset of the arena from the start of the shm segment/file.
uint64_t ps_arena_offset(void* handle) {
  return static_cast<Store*>(handle)->hdr->arena_off;
}

// Create an object of `size` bytes. On success *out_offset is the data offset
// from ps_base(). Evicts LRU unpinned objects on pressure.
int ps_create(void* handle, const uint8_t* id, uint64_t size, uint64_t* out_offset) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return PS_ERROR;
  Entry* existing = find_entry(s, id);
  if (existing) {
    unlock(s);
    return PS_EXISTS;
  }
  uint64_t off = arena_alloc(s, size);
  if (!off) {
    evict_lru(s, align_up(size + sizeof(Block)));
    off = arena_alloc(s, size);
  }
  if (!off) {
    unlock(s);
    return PS_OOM;
  }
  Entry* e = find_slot(s, id);
  if (!e) {
    arena_free(s, off);
    unlock(s);
    return PS_OOM;  // table full
  }
  memcpy(e->id, id, kIdSize);
  e->state = kStateCreated;
  e->offset = off;
  e->data_size = size;
  e->pending_delete = 0;
  e->pin_count = 1;  // creator holds a pin until seal+release
  e->lru_tick = ++s->hdr->lru_clock;
  s->hdr->num_objects++;
  *out_offset = off;
  unlock(s);
  return PS_OK;
}

int ps_seal(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return PS_ERROR;
  Entry* e = find_entry(s, id);
  if (!e) {
    unlock(s);
    return PS_NOT_FOUND;
  }
  e->state = kStateSealed;
  e->lru_tick = ++s->hdr->lru_clock;
  unlock(s);
  return PS_OK;
}

// Get pins the object. *out_offset/*out_size valid when PS_OK.
int ps_get(void* handle, const uint8_t* id, uint64_t* out_offset, uint64_t* out_size) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return PS_ERROR;
  Entry* e = find_entry(s, id);
  if (!e) {
    unlock(s);
    return PS_NOT_FOUND;
  }
  if (e->state != kStateSealed || e->pending_delete) {
    unlock(s);
    return e->pending_delete ? PS_NOT_FOUND : PS_NOT_SEALED;
  }
  e->pin_count++;
  e->lru_tick = ++s->hdr->lru_clock;
  *out_offset = e->offset;
  *out_size = e->data_size;
  unlock(s);
  return PS_OK;
}

int ps_contains(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return 0;
  Entry* e = find_entry(s, id);
  int ok = (e && e->state == kStateSealed && !e->pending_delete) ? 1 : 0;
  unlock(s);
  return ok;
}

int ps_release(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return PS_ERROR;
  Entry* e = find_entry(s, id);
  if (!e) {
    unlock(s);
    return PS_NOT_FOUND;
  }
  if (e->pin_count > 0) e->pin_count--;
  if (e->pin_count == 0 && e->pending_delete) {
    arena_free(s, e->offset);
    e->state = kStateTombstone;
    s->hdr->num_objects--;
  }
  unlock(s);
  return PS_OK;
}

int ps_delete(void* handle, const uint8_t* id) {
  // If readers still pin the object, defer reclamation to the last release —
  // zero-copy views held by live Python values stay valid (same contract as
  // the reference plasma client's buffer refcounting).
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return PS_ERROR;
  Entry* e = find_entry(s, id);
  if (!e) {
    unlock(s);
    return PS_NOT_FOUND;
  }
  if (e->pin_count > 0) {
    e->pending_delete = 1;
    unlock(s);
    return PS_PINNED;
  }
  arena_free(s, e->offset);
  e->state = kStateTombstone;
  s->hdr->num_objects--;
  unlock(s);
  return PS_OK;
}

int ps_abort(void* handle, const uint8_t* id) {
  // Abort an unsealed create (e.g. writer failed mid-copy). Sealed
  // objects are NOT abortable: readers may hold zero-copy views, so
  // freeing here would be a cross-process use-after-free — sealed
  // removal goes through ps_delete's pin-aware path instead.
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return PS_ERROR;
  Entry* e = find_entry(s, id);
  if (!e) {
    unlock(s);
    return PS_NOT_FOUND;
  }
  if (e->state == kStateSealed) {
    unlock(s);
    return PS_NOT_SEALED;  // "wrong state for this op"
  }
  arena_free(s, e->offset);
  e->state = kStateTombstone;
  s->hdr->num_objects--;
  unlock(s);
  return PS_OK;
}

int ps_evict(void* handle, uint64_t bytes, uint64_t* out_freed) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return PS_ERROR;
  *out_freed = evict_lru(s, bytes);
  unlock(s);
  return PS_OK;
}

void ps_stats(void* handle, uint64_t* used, uint64_t* capacity, uint64_t* num_objects,
              uint64_t* evicted_bytes, uint64_t* evicted_count) {
  Store* s = static_cast<Store*>(handle);
  *used = *capacity = *num_objects = *evicted_bytes = *evicted_count = 0;
  if (lock(s) != 0) return;
  *used = s->hdr->used;
  *capacity = s->hdr->capacity;
  *num_objects = s->hdr->num_objects;
  *evicted_bytes = s->hdr->evicted_bytes;
  *evicted_count = s->hdr->evicted_count;
  unlock(s);
}

// Test-only: acquire the store mutex and return WITHOUT unlocking, so a test
// process can exit while "holding" it and exercise the EOWNERDEAD recovery.
int ps_test_lock(void* handle) { return lock(static_cast<Store*>(handle)); }

// Observability: how many owner-death free-list rebuilds have happened, and
// whether the store has been poisoned by unrecoverable corruption.
uint64_t ps_recovered_count(void* handle) {
  return static_cast<Store*>(handle)->hdr->recovered_count;
}

int ps_poisoned(void* handle) {
  return static_cast<Store*>(handle)->hdr->poisoned ? 1 : 0;
}

// List up to max sealed object ids into out (max * kIdSize bytes); returns count.
uint64_t ps_list(void* handle, uint8_t* out, uint64_t max) {
  Store* s = static_cast<Store*>(handle);
  if (lock(s) != 0) return 0;
  uint64_t n = 0;
  for (uint32_t i = 0; i < kTableSize && n < max; i++) {
    Entry* e = &s->hdr->table[i];
    if (e->state == kStateSealed) {
      memcpy(out + n * kIdSize, e->id, kIdSize);
      n++;
    }
  }
  unlock(s);
  return n;
}

}  // extern "C"
