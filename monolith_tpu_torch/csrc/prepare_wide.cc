// The port's multi-table fused prepare, with wide tables.
//
// `cpp/batching.cc::mt_prepare_wire_multi` packs every table's feature
// indices as 16-bit words, so a table may hold at most 65535 unique ids a
// step. `mt_prepare_wire_multi_wide` lays the same wire, except that a
// table marked wide carries one int32 index word a position (-1 invalid):
//
//   wire[0:U)            int32 rows; -1 invalid; bit 30 set on new rows
//   then per stream      narrow: ceil(n_i/2) words of int16 indices, odd
//                        tails padded with -1 (mt_prepare_wire's bytes);
//                        wide: n_i int32 indices
//
// A narrow table runs `mt_prepare_wire` (the same bytes as
// mt_prepare_wire_multi). A wide table is deduped by `mt_batcher_dedup`
// (or `mt_batcher_dedup2`), which writes int32 indices straight into the
// wire, and its unique ids are mapped through the store as
// `EmbeddingEngine.prepare_batch` maps them: with each id's occurrences in
// the step only where the table has an admission filter, else counted once
// a step. Each table is one task on the host pool, largest first (by ids),
// so that the longest prepare is not the last one picked up.
//
// This file builds into the port's host library beside cpp/ (build.py) and
// calls only cpp/'s C entry points.

#include <algorithm>
#include <cstdint>
#include <vector>

#include "threadpool.h"

extern "C" {
int64_t mt_prepare_wire(void* batcher, void* store,
                        const int64_t* const* streams, const int64_t* sizes,
                        int32_t n_streams, uint32_t ts, int64_t unique_cap,
                        int64_t new_cap, int32_t record_touch, int32_t* wire,
                        int64_t* stats);
int64_t mt_batcher_dedup(void* b, const int64_t* values, int64_t n,
                         int32_t num_shards, int64_t shard_cap,
                         int64_t* out_unique, int32_t* out_index,
                         int32_t* out_shard_counts);
int64_t mt_batcher_dedup2(void* b, const int64_t* values, int64_t n,
                          int32_t num_shards, int64_t shard_cap,
                          int64_t* out_unique, int32_t* out_index,
                          int32_t* out_shard_counts, int32_t* out_occurrence);
void mt_store_map_train_pos2(void* s, const int64_t* fids, int64_t n,
                             uint32_t ts, const int32_t* counts,
                             int32_t* out_rows, int32_t* out_new_rows,
                             int64_t* out_new_fids, int32_t* out_new_pos,
                             int64_t new_cap, int64_t* out_new_count,
                             int32_t record_touch);
}

namespace {

// A table's width on the wire (`widths` of mt_prepare_wire_multi_wide).
constexpr int32_t kNarrow = 0;        // 16-bit index words
constexpr int32_t kWide = 1;          // int32 words; an id counts once a step
constexpr int32_t kWideCounted = 2;   // int32 words; an id counts each time

// One wide table's region of the wire; stats as mt_prepare_wire's.
// Returns the region's length in words.
int64_t PrepareWide(void* batcher, void* store, const int64_t* const* streams,
                    const int64_t* sizes, int32_t n_streams, uint32_t ts,
                    int64_t unique_cap, int64_t new_cap, int32_t record_touch,
                    bool counted, int32_t* wire, int64_t* stats) {
  int64_t n = 0;
  for (int32_t i = 0; i < n_streams; ++i) n += sizes[i];
  // the dedup takes one stream: a table of several features is laid end to
  // end, which is the order of its index words on the wire
  thread_local std::vector<int64_t> flat;
  const int64_t* values = n_streams == 1 ? streams[0] : nullptr;
  if (!values) {
    flat.resize(n);
    int64_t off = 0;
    for (int32_t i = 0; i < n_streams; ++i) {
      std::copy(streams[i], streams[i] + sizes[i], flat.data() + off);
      off += sizes[i];
    }
    values = flat.data();
  }
  thread_local std::vector<int64_t> unique;
  thread_local std::vector<int32_t> occ, new_rows, new_pos;
  thread_local std::vector<int64_t> new_fids;
  if ((int64_t)unique.size() < unique_cap) {
    unique.resize(unique_cap);
    occ.resize(unique_cap);
  }
  if ((int64_t)new_rows.size() < new_cap) {
    new_rows.resize(new_cap);
    new_pos.resize(new_cap);
    new_fids.resize(new_cap);
  }
  int32_t count = 0;
  int32_t* index = wire + unique_cap;
  const int64_t overflow =
      counted ? mt_batcher_dedup2(batcher, values, n, 1, unique_cap,
                                  unique.data(), index, &count, occ.data())
              : mt_batcher_dedup(batcher, values, n, 1, unique_cap,
                                 unique.data(), index, &count);

  // Map the unique ids through the store, writing rows straight into the
  // wire head; stamp bit 30 on newly admitted positions.
  std::fill(wire, wire + unique_cap, -1);
  int64_t n_new = 0;
  mt_store_map_train_pos2(store, unique.data(), count, ts,
                          counted ? occ.data() : nullptr, wire,
                          new_rows.data(), new_fids.data(), new_pos.data(),
                          new_cap, &n_new, record_touch);
  const int64_t n_marked = std::min(n_new, new_cap);
  for (int64_t i = 0; i < n_marked; ++i) wire[new_pos[i]] |= (1 << 30);
  int64_t filtered = 0;
  for (int64_t i = 0; i < count; ++i) filtered += wire[i] == -1;

  stats[0] = overflow;
  stats[1] = n_marked;
  stats[2] = count;
  stats[4] = n_new - n_marked;  // rejected: admission budget exhausted
  stats[3] = filtered - stats[4];
  return unique_cap + n;
}

}  // namespace

extern "C" {

// mt_prepare_wire_multi with a width a table (`widths[t]`: kNarrow,
// kWide or kWideCounted above); the other arguments and the stats are
// mt_prepare_wire_multi's. Returns the wire words written
// (wire_offsets[n_tables]).
int64_t mt_prepare_wire_multi_wide(int32_t n_tables, void** batchers,
                                   void** stores,
                                   const int64_t* const* streams,
                                   const int64_t* sizes,
                                   const int64_t* stream_offsets,
                                   const int64_t* wire_offsets, uint32_t ts,
                                   const int64_t* unique_caps,
                                   const int64_t* new_caps,
                                   const int32_t* widths,
                                   int32_t record_touch, int32_t* wire,
                                   int64_t* stats) {
  if (n_tables <= 0) return 0;
  std::vector<int64_t> ids(n_tables, 0), order(n_tables);
  for (int32_t t = 0; t < n_tables; ++t) {
    order[t] = t;
    for (int64_t s = stream_offsets[t]; s < stream_offsets[t + 1]; ++s)
      ids[t] += sizes[s];
  }
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return ids[a] > ids[b]; });
  ThreadPool::Global().ParallelFor(n_tables, [&](int64_t i) {
    const int64_t t = order[i];
    const int64_t s0 = stream_offsets[t];
    const int32_t n_streams = (int32_t)(stream_offsets[t + 1] - s0);
    if (widths[t] == kNarrow) {
      mt_prepare_wire(batchers[t], stores[t], streams + s0, sizes + s0,
                      n_streams, ts, unique_caps[t], new_caps[t],
                      record_touch, wire + wire_offsets[t], stats + t * 5);
    } else {
      PrepareWide(batchers[t], stores[t], streams + s0, sizes + s0,
                  n_streams, ts, unique_caps[t], new_caps[t], record_touch,
                  widths[t] == kWideCounted, wire + wire_offsets[t],
                  stats + t * 5);
    }
  });
  return wire_offsets[n_tables];
}

}  // extern "C"
