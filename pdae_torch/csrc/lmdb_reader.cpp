// Read-only LMDB environment reader: mmap + B+tree search, zero-copy values.
//
// The port's copy of native/lmdb_reader.cpp, byte for byte below this
// comment: the native counterpart of pdae_torch/data/lmdb_store.py's
// pure-Python Reader (the same on-disk format), used on the input
// pipeline's hot path, where the multi-million-image LSUN datasets
// (horse/bedroom) make Python's per-key overhead visible. Exposed through
// ctypes (see lmdb_store.py), built by utils/_host_build.py.
//
// Format: see the docstring in lmdb_store.py.  64-bit little-endian.

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr uint32_t kVersion = 1;

constexpr uint16_t kBranch = 0x01;
constexpr uint16_t kLeaf = 0x02;
constexpr uint16_t kBigData = 0x01;  // node flag

constexpr size_t kPageHdr = 16;
constexpr size_t kNodeHdr = 8;
constexpr uint64_t kInvalidPage = ~0ULL;

#pragma pack(push, 1)
struct PageHeader {
  uint64_t pgno;
  uint16_t pad;
  uint16_t flags;
  uint16_t lower;
  uint16_t upper;
};

struct Node {
  uint16_t lo;
  uint16_t hi;
  uint16_t flags;
  uint16_t ksize;
  // key bytes, then data bytes / overflow pgno
};

struct MDBDb {
  uint32_t pad;
  uint16_t flags;
  uint16_t depth;
  uint64_t branch_pages;
  uint64_t leaf_pages;
  uint64_t overflow_pages;
  uint64_t entries;
  uint64_t root;
};

struct Meta {
  uint32_t magic;
  uint32_t version;
  uint64_t address;
  uint64_t mapsize;
  MDBDb dbs[2];
  uint64_t last_pg;
  uint64_t txnid;
};
#pragma pack(pop)

struct Env {
  const uint8_t* map = nullptr;
  size_t size = 0;
  uint32_t psize = 0;
  uint64_t root = kInvalidPage;
  uint64_t entries = 0;
  int fd = -1;
};

const Meta* meta_at(const Env& env, size_t off) {
  if (off + kPageHdr + sizeof(Meta) > env.size) return nullptr;
  const Meta* m = reinterpret_cast<const Meta*>(env.map + off + kPageHdr);
  if (m->magic != kMagic || m->version != kVersion) return nullptr;
  return m;
}

// Every accessor below bounds-checks against the mmap: a truncated or
// corrupt data.mdb (partial copy of a published LMDB) must surface as a
// catchable -2 "corruption" result like the pure-python Reader's
// exception, never as a SIGSEGV in a loader worker.

inline const PageHeader* page(const Env& env, uint64_t pgno) {
  if (env.psize == 0 || pgno > env.size / env.psize) return nullptr;
  size_t off = size_t(pgno) * env.psize;
  if (off + env.psize > env.size) return nullptr;   // whole page mapped
  return reinterpret_cast<const PageHeader*>(env.map + off);
}

inline uint32_t num_keys(const Env& env, const PageHeader* p) {
  if (p->lower < kPageHdr || p->lower > env.psize) return 0;
  return (p->lower - kPageHdr) >> 1;
}

inline const Node* node_at(const Env& env, const PageHeader* p, uint32_t i) {
  const uint8_t* base = reinterpret_cast<const uint8_t*>(p);
  const uint16_t* ptrs =
      reinterpret_cast<const uint16_t*>(base + kPageHdr);
  uint16_t off = ptrs[i];
  // node header + key must lie inside this page
  if (off < kPageHdr || size_t(off) + kNodeHdr > env.psize) return nullptr;
  const Node* n = reinterpret_cast<const Node*>(base + off);
  if (size_t(off) + kNodeHdr + n->ksize > env.psize) return nullptr;
  return n;
}

inline const uint8_t* node_key(const Node* n) {
  return reinterpret_cast<const uint8_t*>(n) + kNodeHdr;
}

inline int key_cmp(const uint8_t* a, size_t alen, const uint8_t* b,
                   size_t blen) {
  size_t n = alen < blen ? alen : blen;
  int c = memcmp(a, b, n);
  if (c) return c;
  return (alen > blen) - (alen < blen);
}

inline uint64_t branch_child(const Node* n) {
  return uint64_t(n->lo) | (uint64_t(n->hi) << 16)
       | (uint64_t(n->flags) << 32);
}

}  // namespace

extern "C" {

void* pdae_lmdb_open(const char* path) {
  Env* env = new Env();
  env->fd = open(path, O_RDONLY);
  if (env->fd < 0) { delete env; return nullptr; }
  struct stat st;
  if (fstat(env->fd, &st) != 0) { close(env->fd); delete env; return nullptr; }
  env->size = size_t(st.st_size);
  env->map = static_cast<const uint8_t*>(
      mmap(nullptr, env->size, PROT_READ, MAP_SHARED, env->fd, 0));
  if (env->map == MAP_FAILED) { close(env->fd); delete env; return nullptr; }

  env->psize = 4096;  // provisional, to parse meta 0
  const Meta* m0 = meta_at(*env, 0);
  if (!m0) {
    munmap(const_cast<uint8_t*>(env->map), env->size);
    close(env->fd);
    delete env;
    return nullptr;
  }
  env->psize = m0->dbs[0].pad;
  if (env->psize < 512 || env->psize > (1u << 16) ||
      (env->psize & (env->psize - 1)) != 0) {
    munmap(const_cast<uint8_t*>(env->map), env->size);
    close(env->fd);
    delete env;
    return nullptr;
  }
  const Meta* m1 = meta_at(*env, env->psize);
  const Meta* live = (m1 && m1->txnid > m0->txnid) ? m1 : m0;
  env->root = live->dbs[1].root;
  env->entries = live->dbs[1].entries;
  return env;
}

uint64_t pdae_lmdb_entries(void* handle) {
  return static_cast<Env*>(handle)->entries;
}

// Returns 0 on hit (val/vlen set, pointing into the mmap), -1 on miss,
// -2 on corruption.
int pdae_lmdb_get(void* handle, const uint8_t* key, size_t klen,
                  const uint8_t** val, size_t* vlen) {
  const Env& env = *static_cast<Env*>(handle);
  if (env.root == kInvalidPage) return -1;
  const PageHeader* p = page(env, env.root);
  // depth bound: real LMDB trees are <10 levels; a cyclic/corrupt page
  // graph must terminate instead of looping forever
  for (int depth = 0; p && depth < 64; ++depth) {
    uint32_t n = num_keys(env, p);
    if (p->flags & kBranch) {
      if (n == 0) return -2;
      // first branch key is implicit-empty; rightmost node with key <= k
      uint32_t lo = 1, hi = n - 1, pos = 0;
      while (n > 1 && lo <= hi) {
        uint32_t mid = (lo + hi) / 2;
        const Node* nd = node_at(env, p, mid);
        if (!nd) return -2;
        if (key_cmp(node_key(nd), nd->ksize, key, klen) <= 0) {
          pos = mid;
          lo = mid + 1;
        } else {
          if (mid == 0) break;
          hi = mid - 1;
        }
      }
      const Node* child = node_at(env, p, pos);
      if (!child) return -2;
      p = page(env, branch_child(child));
    } else if (p->flags & kLeaf) {
      int lo = 0, hi = int(n) - 1;
      while (lo <= hi) {
        int mid = (lo + hi) / 2;
        const Node* nd = node_at(env, p, mid);
        if (!nd) return -2;
        int c = key_cmp(node_key(nd), nd->ksize, key, klen);
        if (c == 0) {
          size_t dsize = size_t(nd->lo) | (size_t(nd->hi) << 16);
          const uint8_t* data = node_key(nd) + nd->ksize;
          if (nd->flags & kBigData) {
            if (data + 8 >
                reinterpret_cast<const uint8_t*>(p) + env.psize)
              return -2;
            uint64_t ovf;
            memcpy(&ovf, data, 8);
            // overflow values span CONTIGUOUS pages: the whole value
            // (not just the first page) must be inside the mapping
            if (env.psize == 0 || ovf > env.size / env.psize) return -2;
            size_t start = size_t(ovf) * env.psize + kPageHdr;
            if (start > env.size || dsize > env.size - start) return -2;
            *val = env.map + start;
          } else {
            // inline value must end inside this page
            size_t off = size_t(data - reinterpret_cast<const uint8_t*>(p));
            if (off > env.psize || dsize > env.psize - off) return -2;
            *val = data;
          }
          *vlen = dsize;
          return 0;
        }
        if (c < 0) lo = mid + 1; else hi = mid - 1;
      }
      return -1;
    } else {
      return -2;
    }
  }
  return -2;
}

void pdae_lmdb_close(void* handle) {
  Env* env = static_cast<Env*>(handle);
  if (env->map && env->map != MAP_FAILED)
    munmap(const_cast<uint8_t*>(env->map), env->size);
  if (env->fd >= 0) close(env->fd);
  delete env;
}

}  // extern "C"
