// Native serving runtime: paged-KV allocator + radix prefix cache.
//
// Host C++ (no CUDA): the per-step continuous-batching bookkeeping — page
// allocation, longest-prefix KV reuse (radix cache), page-table assembly —
// runs in native code so the Python step loop stays off the critical path
// at large batch. The same C ABI and behaviour as the JAX package's
// csrc/serving_native.cpp, of which this is the port's own copy.
//
// Exposed as a C ABI consumed via ctypes (sgl_kernel_tpu_torch/serving/
// native.py), which builds it on first use with
// `c++ -O2 -std=c++17 -shared -fPIC` into sgl_kernel_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct RadixNode {
  // edge label: token sequence from parent to this node
  std::vector<int32_t> tokens;
  // pages covering this edge's tokens (page i covers tokens
  // [i*page_size, ...) of the edge, relative to the edge start offset)
  std::vector<int32_t> pages;
  std::map<int32_t, std::unique_ptr<RadixNode>> children;
  RadixNode* parent = nullptr;
  uint64_t last_access = 0;
  int32_t ref_count = 0;
};

struct Allocator {
  std::vector<int32_t> free_pages;  // stack
  int32_t num_pages = 0;
  int32_t page_size = 1;

  // radix prefix cache
  RadixNode root;
  uint64_t clock = 0;
  int64_t cached_pages = 0;
  // live prefix locks: lock id -> exact set of pinned nodes. Pins are
  // released by handle (not by token replay) so edge splits cannot strand
  // a stale pin: a split adds the new tail to every lock set pinning the
  // original edge, keeping ref_count == sum of lock-set occurrences.
  std::unordered_map<int64_t, std::vector<RadixNode*>> locks;
  int64_t next_lock = 1;
};

std::mutex g_mu;
std::unordered_map<int64_t, std::unique_ptr<Allocator>> g_allocs;
int64_t g_next_id = 1;

Allocator* get(int64_t h) {
  auto it = g_allocs.find(h);
  return it == g_allocs.end() ? nullptr : it->second.get();
}

void collect_pages(RadixNode* n, std::vector<RadixNode*>* leaves) {
  if (n->children.empty() && n->parent != nullptr && n->ref_count == 0) {
    leaves->push_back(n);
  }
  for (auto& kv : n->children) collect_pages(kv.second.get(), leaves);
}

}  // namespace

extern "C" {

int64_t sn_create(int32_t num_pages, int32_t page_size) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto a = std::make_unique<Allocator>();
  a->num_pages = num_pages;
  a->page_size = page_size;
  a->free_pages.reserve(num_pages);
  // page 0 reserved as the pad page (decode-kernel convention)
  for (int32_t p = num_pages - 1; p >= 1; --p) a->free_pages.push_back(p);
  int64_t h = g_next_id++;
  g_allocs[h] = std::move(a);
  return h;
}

void sn_destroy(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_allocs.erase(h);
}

int32_t sn_free_count(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mu);
  Allocator* a = get(h);
  return a ? static_cast<int32_t>(a->free_pages.size()) : -1;
}

// Allocate n pages into out[n]. Returns n on success, -1 if insufficient.
int32_t sn_alloc(int64_t h, int32_t n, int32_t* out) {
  std::lock_guard<std::mutex> lock(g_mu);
  Allocator* a = get(h);
  if (!a || static_cast<int32_t>(a->free_pages.size()) < n) return -1;
  for (int32_t i = 0; i < n; ++i) {
    out[i] = a->free_pages.back();
    a->free_pages.pop_back();
  }
  return n;
}

void sn_release(int64_t h, int32_t n, const int32_t* pages) {
  std::lock_guard<std::mutex> lock(g_mu);
  Allocator* a = get(h);
  if (!a) return;
  for (int32_t i = 0; i < n; ++i) a->free_pages.push_back(pages[i]);
}

// Assemble [batch, max_pages] page tables from a ragged page list.
// pages_flat: concatenated per-request page ids; counts[b] lengths.
void sn_assemble_tables(
    int32_t batch, int32_t max_pages, const int32_t* pages_flat, const int32_t* counts, int32_t* out) {
  std::memset(out, 0, sizeof(int32_t) * batch * max_pages);
  int64_t off = 0;
  for (int32_t b = 0; b < batch; ++b) {
    int32_t n = counts[b];
    if (n > max_pages) n = max_pages;
    std::memcpy(out + static_cast<int64_t>(b) * max_pages, pages_flat + off, sizeof(int32_t) * n);
    off += counts[b];
  }
}

// ---- radix prefix cache -------------------------------------------------
// Cache granularity is whole pages: only full pages of tokens are inserted
// or matched (partial trailing pages stay private to the request).

// Longest-prefix match: returns number of matched TOKENS (multiple of
// page_size); writes the covering page ids into out_pages (cap max_out).
static int32_t radix_walk(Allocator* a, const int32_t* tokens, int32_t n_tokens, int32_t* out_pages, int32_t max_out, std::vector<RadixNode*>* pin_set) {
  a->clock++;
  RadixNode* node = &a->root;
  int32_t matched_tokens = 0;
  int32_t out_n = 0;
  int32_t pos = 0;
  while (pos < n_tokens) {
    auto it = node->children.find(tokens[pos]);
    if (it == node->children.end()) break;
    RadixNode* child = it->second.get();
    int32_t elen = static_cast<int32_t>(child->tokens.size());
    int32_t cmp = 0;
    while (cmp < elen && pos + cmp < n_tokens && child->tokens[cmp] == tokens[pos + cmp]) cmp++;
    child->last_access = a->clock;
    if (cmp < elen) {
      // partial edge match: reuse the page-aligned covered prefix; a
      // partially-matched edge is still pinned as a whole
      int32_t pg = cmp / a->page_size;
      if (pg > 0 && pin_set != nullptr) {
        child->ref_count++;
        pin_set->push_back(child);
      }
      for (int32_t i = 0; i < pg && out_pages != nullptr && out_n < max_out; ++i) out_pages[out_n++] = child->pages[i];
      matched_tokens += pg * a->page_size;
      break;
    }
    if (pin_set != nullptr) {
      child->ref_count++;
      pin_set->push_back(child);
    }
    for (int32_t p : child->pages) {
      if (out_pages != nullptr && out_n < max_out) out_pages[out_n++] = p;
    }
    matched_tokens += elen;
    pos += elen;
    node = child;
  }
  return matched_tokens;
}

// Longest-prefix match (read-only; no pinning).
int32_t sn_radix_match(int64_t h, const int32_t* tokens, int32_t n_tokens, int32_t* out_pages, int32_t max_out) {
  std::lock_guard<std::mutex> lock(g_mu);
  Allocator* a = get(h);
  if (!a) return -1;
  return radix_walk(a, tokens, n_tokens, out_pages, max_out, nullptr);
}

// Match + pin: increments ref_count along the matched path so eviction
// cannot free pages a live request references. Writes a lock handle to
// *out_lock; release with sn_radix_unlock(h, lock_id).
int32_t sn_radix_match_lock(int64_t h, const int32_t* tokens, int32_t n_tokens, int32_t* out_pages, int32_t max_out, int64_t* out_lock) {
  std::lock_guard<std::mutex> lock(g_mu);
  Allocator* a = get(h);
  if (!a) return -1;
  std::vector<RadixNode*> pins;
  int32_t matched = radix_walk(a, tokens, n_tokens, out_pages, max_out, &pins);
  int64_t id = a->next_lock++;
  a->locks[id] = std::move(pins);
  if (out_lock != nullptr) *out_lock = id;
  return matched;
}

// Unpin a previously locked path by handle. Decrements exactly the nodes
// this lock pinned (including tails added by later edge splits).
int32_t sn_radix_unlock(int64_t h, int64_t lock_id) {
  std::lock_guard<std::mutex> lock(g_mu);
  Allocator* a = get(h);
  if (!a) return -1;
  auto it = a->locks.find(lock_id);
  if (it == a->locks.end()) return -1;
  for (RadixNode* n : it->second) n->ref_count--;
  a->locks.erase(it);
  return 0;
}

// Insert a page-aligned token prefix with its page ids. Tokens beyond
// n_pages*page_size are ignored. The pages become owned by the cache
// (caller must not release them); returns number of NEW pages adopted.
int32_t sn_radix_insert(int64_t h, const int32_t* tokens, int32_t n_tokens, const int32_t* pages, int32_t n_pages) {
  std::lock_guard<std::mutex> lock(g_mu);
  Allocator* a = get(h);
  if (!a) return -1;
  a->clock++;
  int32_t ps = a->page_size;
  int32_t usable = n_tokens / ps;
  if (usable > n_pages) usable = n_pages;

  RadixNode* node = &a->root;
  int32_t page_idx = 0;
  int32_t pos = 0;
  while (page_idx < usable) {
    auto it = node->children.find(tokens[pos]);
    if (it != node->children.end()) {
      RadixNode* child = it->second.get();
      int32_t elen = static_cast<int32_t>(child->tokens.size());
      int32_t cmp = 0;
      while (cmp < elen && pos + cmp < usable * ps && child->tokens[cmp] == tokens[pos + cmp]) cmp++;
      if (cmp == elen) {
        child->last_access = a->clock;
        pos += elen;
        page_idx += elen / ps;
        node = child;
        continue;
      }
      // divergence inside the edge: split it at the page-aligned point so
      // the shared prefix is deduplicated
      int32_t split_tok = (cmp / ps) * ps;
      if (split_tok == 0) break;  // no shared full page on this edge
      auto tail = std::make_unique<RadixNode>();
      tail->tokens.assign(child->tokens.begin() + split_tok, child->tokens.end());
      tail->pages.assign(child->pages.begin() + split_tok / ps, child->pages.end());
      tail->last_access = child->last_access;
      // every lock pinning this edge must pin both halves: copy the pin
      // count and add the tail to each lock set holding the head, keeping
      // unlock-by-handle exact
      tail->ref_count = child->ref_count;
      if (tail->ref_count > 0) {
        for (auto& lk : a->locks) {
          auto& v = lk.second;
          size_t vn = v.size();
          for (size_t i = 0; i < vn; ++i)
            if (v[i] == child) v.push_back(tail.get());
        }
      }
      child->tokens.resize(split_tok);
      child->pages.resize(split_tok / ps);
      tail->parent = child;
      // move grandchildren under tail
      tail->children = std::move(child->children);
      for (auto& kv : tail->children) kv.second->parent = tail.get();
      child->children.clear();
      child->children[tail->tokens[0]] = std::move(tail);
      pos += split_tok;
      page_idx += split_tok / ps;
      node = child;
      continue;
    }
    // new edge with the remaining pages
    auto child = std::make_unique<RadixNode>();
    child->tokens.assign(tokens + pos, tokens + usable * ps);
    child->pages.assign(pages + page_idx, pages + usable);
    child->parent = node;
    child->last_access = a->clock;
    int32_t adopted = usable - page_idx;
    a->cached_pages += adopted;
    node->children[tokens[pos]] = std::move(child);
    return adopted;
  }
  return 0;
}

// Evict least-recently-used unreferenced leaves until >= want pages are
// freed (returned to the allocator). Returns pages actually freed.
int32_t sn_radix_evict(int64_t h, int32_t want) {
  std::lock_guard<std::mutex> lock(g_mu);
  Allocator* a = get(h);
  if (!a) return -1;
  int32_t freed = 0;
  while (freed < want) {
    std::vector<RadixNode*> leaves;
    collect_pages(&a->root, &leaves);
    if (leaves.empty()) break;
    RadixNode* lru = leaves[0];
    for (RadixNode* n : leaves)
      if (n->last_access < lru->last_access) lru = n;
    for (int32_t p : lru->pages) a->free_pages.push_back(p);
    freed += static_cast<int32_t>(lru->pages.size());
    a->cached_pages -= static_cast<int64_t>(lru->pages.size());
    // unlink from parent
    RadixNode* parent = lru->parent;
    for (auto it = parent->children.begin(); it != parent->children.end(); ++it) {
      if (it->second.get() == lru) {
        parent->children.erase(it);
        break;
      }
    }
  }
  return freed;
}

int64_t sn_radix_cached_pages(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mu);
  Allocator* a = get(h);
  return a ? a->cached_pages : -1;
}

}  // extern "C"
