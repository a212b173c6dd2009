// Native data-feed: multithreaded MultiSlot file parsing, in-memory record
// store, shuffle, and padded batch assembly, exposed through a C ABI consumed
// via ctypes (paddle_tpu/dataset.py).
//
// TPU-native equivalent of the reference's C++ data ingestion layer
// (reference: paddle/fluid/framework/data_feed.cc MultiSlotDataFeed — text
// format "per slot: <count> v...", data_set.cc DatasetImpl LoadIntoMemory /
// LocalShuffle). Parsing and batch assembly run in native threads so the
// Python training loop never touches per-sample data; variable-length slots
// come out as padded dense arrays + length vectors (the TPU answer to LoD,
// SURVEY §5.7).
//
// Build: g++ -O2 -shared -fPIC -pthread -o libdatafeed.so datafeed.cc

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

enum SlotType { kFloat = 0, kInt64 = 1 };

struct SlotDesc {
  std::string name;
  SlotType type;
  int fixed_len;  // >0 dense, -1 variable-length
};

struct SlotRef {
  uint64_t offset;
  uint32_t len;
};

// Per-thread parse output, merged after join.
struct Shard {
  std::vector<std::vector<float>> fpool;
  std::vector<std::vector<int64_t>> ipool;
  std::vector<SlotRef> refs;  // nrecords * nslots
  size_t nrecords = 0;
  std::string error;
};

struct Dataset {
  std::vector<SlotDesc> slots;
  std::vector<std::vector<float>> fpool;    // per slot
  std::vector<std::vector<int64_t>> ipool;  // per slot
  std::vector<SlotRef> refs;                // nrecords * nslots
  size_t nrecords = 0;

  // pass state
  std::vector<uint64_t> order;
  size_t cursor = 0;
  int batch_size = 1;
  bool drop_last = false;
  std::vector<uint64_t> cur_batch;  // record indices
  std::string error;
};

bool parse_line(const char* p, const char* end,
                const std::vector<SlotDesc>& slots, Shard* out) {
  size_t base = out->refs.size();
  out->refs.resize(base + slots.size());
  for (size_t s = 0; s < slots.size(); ++s) {
    char* next = nullptr;
    long cnt = strtol(p, &next, 10);
    if (next == p || cnt < 0) return false;
    p = next;
    SlotRef& r = out->refs[base + s];
    r.len = static_cast<uint32_t>(cnt);
    if (slots[s].type == kFloat) {
      r.offset = out->fpool[s].size();
      for (long i = 0; i < cnt; ++i) {
        float v = strtof(p, &next);
        if (next == p) return false;
        out->fpool[s].push_back(v);
        p = next;
      }
    } else {
      r.offset = out->ipool[s].size();
      for (long i = 0; i < cnt; ++i) {
        long long v = strtoll(p, &next, 10);
        if (next == p) return false;
        out->ipool[s].push_back(static_cast<int64_t>(v));
        p = next;
      }
    }
    if (p > end) return false;
  }
  out->nrecords++;
  return true;
}

void parse_buffer(const char* data, size_t n, const std::vector<SlotDesc>& slots,
                  Shard* shard) {
  const char* p = data;
  const char* end = data + n;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    if (line_end > p) {
      if (!parse_line(p, line_end, slots, shard)) {
        shard->error = "malformed MultiSlot line: " +
                       std::string(p, std::min<size_t>(line_end - p, 120));
        return;
      }
    }
    p = line_end + 1;
  }
}

void parse_file(const std::string& path, const std::vector<SlotDesc>& slots,
                Shard* shard) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    shard->error = "cannot open " + path;
    return;
  }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(n, '\0');
  if (n > 0 && fread(&buf[0], 1, n, f) != static_cast<size_t>(n)) {
    shard->error = "short read on " + path;
    fclose(f);
    return;
  }
  fclose(f);
  parse_buffer(buf.data(), buf.size(), slots, shard);
}

void merge_shard(Dataset* ds, Shard&& sh) {
  size_t nslots = ds->slots.size();
  std::vector<uint64_t> fbase(nslots), ibase(nslots);
  for (size_t s = 0; s < nslots; ++s) {
    fbase[s] = ds->fpool[s].size();
    ibase[s] = ds->ipool[s].size();
    ds->fpool[s].insert(ds->fpool[s].end(), sh.fpool[s].begin(),
                        sh.fpool[s].end());
    ds->ipool[s].insert(ds->ipool[s].end(), sh.ipool[s].begin(),
                        sh.ipool[s].end());
  }
  size_t base = ds->refs.size();
  ds->refs.resize(base + sh.refs.size());
  for (size_t r = 0; r < sh.nrecords; ++r) {
    for (size_t s = 0; s < nslots; ++s) {
      SlotRef ref = sh.refs[r * nslots + s];
      ref.offset += (ds->slots[s].type == kFloat) ? fbase[s] : ibase[s];
      ds->refs[base + r * nslots + s] = ref;
    }
  }
  ds->nrecords += sh.nrecords;
}

Shard make_shard(size_t nslots) {
  Shard sh;
  sh.fpool.resize(nslots);
  sh.ipool.resize(nslots);
  return sh;
}

}  // namespace

extern "C" {

// slot_spec: comma-separated "name:f|i:len" (len=-1 for variable length)
void* paddle_ds_create(const char* slot_spec) {
  auto* ds = new Dataset();
  std::string spec(slot_spec);
  size_t pos = 0;
  while (pos < spec.size()) {
    size_t comma = spec.find(',', pos);
    if (comma == std::string::npos) comma = spec.size();
    std::string item = spec.substr(pos, comma - pos);
    size_t c1 = item.find(':');
    size_t c2 = item.find(':', c1 + 1);
    if (c1 == std::string::npos || c2 == std::string::npos) {
      delete ds;
      return nullptr;
    }
    SlotDesc d;
    d.name = item.substr(0, c1);
    d.type = item[c1 + 1] == 'f' ? kFloat : kInt64;
    d.fixed_len = atoi(item.c_str() + c2 + 1);
    ds->slots.push_back(d);
    pos = comma + 1;
  }
  ds->fpool.resize(ds->slots.size());
  ds->ipool.resize(ds->slots.size());
  return ds;
}

void paddle_ds_destroy(void* h) { delete static_cast<Dataset*>(h); }

const char* paddle_ds_error(void* h) {
  return static_cast<Dataset*>(h)->error.c_str();
}

// Threaded load: files are split across nthreads native parser threads
// (reference: data_set.cc LoadIntoMemory thread-per-channel).
int paddle_ds_load_files(void* h, const char** paths, int nfiles,
                         int nthreads) {
  auto* ds = static_cast<Dataset*>(h);
  if (nthreads < 1) nthreads = 1;
  if (nthreads > nfiles) nthreads = nfiles > 0 ? nfiles : 1;
  std::vector<Shard> shards;
  shards.reserve(nfiles);
  for (int i = 0; i < nfiles; ++i) shards.push_back(make_shard(ds->slots.size()));
  std::atomic<int> next_file(0);
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([&]() {
      for (int i = next_file.fetch_add(1); i < nfiles;
           i = next_file.fetch_add(1)) {
        parse_file(paths[i], ds->slots, &shards[i]);
      }
    });
  }
  for (auto& t : threads) t.join();
  // validate every shard BEFORE merging any: a partial merge would leave
  // duplicate records behind a failed-then-retried load
  for (int i = 0; i < nfiles; ++i) {
    if (!shards[i].error.empty()) {
      ds->error = shards[i].error;
      return -1;
    }
  }
  for (int i = 0; i < nfiles; ++i) merge_shard(ds, std::move(shards[i]));
  return 0;
}

int paddle_ds_load_buffer(void* h, const char* data, long n) {
  auto* ds = static_cast<Dataset*>(h);
  Shard sh = make_shard(ds->slots.size());
  parse_buffer(data, static_cast<size_t>(n), ds->slots, &sh);
  if (!sh.error.empty()) {
    ds->error = sh.error;
    return -1;
  }
  merge_shard(ds, std::move(sh));
  return 0;
}

long paddle_ds_size(void* h) {
  return static_cast<long>(static_cast<Dataset*>(h)->nrecords);
}

void paddle_ds_shuffle(void* h, unsigned seed) {
  auto* ds = static_cast<Dataset*>(h);
  if (ds->order.size() != ds->nrecords) {
    ds->order.resize(ds->nrecords);
    for (size_t i = 0; i < ds->nrecords; ++i) ds->order[i] = i;
  }
  std::mt19937_64 gen(seed);
  std::shuffle(ds->order.begin(), ds->order.end(), gen);
}

void paddle_ds_begin_pass(void* h, int batch_size, int drop_last) {
  auto* ds = static_cast<Dataset*>(h);
  if (ds->order.size() != ds->nrecords) {
    ds->order.resize(ds->nrecords);
    for (size_t i = 0; i < ds->nrecords; ++i) ds->order[i] = i;
  }
  ds->cursor = 0;
  ds->batch_size = batch_size;
  ds->drop_last = drop_last != 0;
}

// Advance to the next batch; returns its size (0 = end of pass).
int paddle_ds_next_batch(void* h) {
  auto* ds = static_cast<Dataset*>(h);
  size_t remaining = ds->nrecords - ds->cursor;
  size_t take = std::min<size_t>(ds->batch_size, remaining);
  if (take == 0 || (ds->drop_last && take < static_cast<size_t>(ds->batch_size)))
    return 0;
  ds->cur_batch.assign(ds->order.begin() + ds->cursor,
                       ds->order.begin() + ds->cursor + take);
  ds->cursor += take;
  return static_cast<int>(take);
}

// Max slot length within the current batch (== fixed_len for dense slots).
int paddle_ds_batch_maxlen(void* h, int slot) {
  auto* ds = static_cast<Dataset*>(h);
  size_t nslots = ds->slots.size();
  uint32_t m = 0;
  for (uint64_t r : ds->cur_batch)
    m = std::max(m, ds->refs[r * nslots + slot].len);
  return static_cast<int>(m);
}

// Copy the current batch's slot into out (padded [B, maxlen] row-major) and
// per-row lengths into lens. Returns maxlen. out must hold B*maxlen
// elements of the slot dtype; lens must hold B int64s (may be null).
int paddle_ds_batch_copy(void* h, int slot, void* out, int64_t* lens,
                         int maxlen) {
  auto* ds = static_cast<Dataset*>(h);
  size_t nslots = ds->slots.size();
  const SlotDesc& d = ds->slots[slot];
  for (size_t i = 0; i < ds->cur_batch.size(); ++i) {
    const SlotRef& ref = ds->refs[ds->cur_batch[i] * nslots + slot];
    uint32_t n = std::min<uint32_t>(ref.len, maxlen);
    if (lens) lens[i] = ref.len;
    if (d.type == kFloat) {
      float* row = static_cast<float*>(out) + i * static_cast<size_t>(maxlen);
      memcpy(row, ds->fpool[slot].data() + ref.offset, n * sizeof(float));
      for (uint32_t j = n; j < static_cast<uint32_t>(maxlen); ++j) row[j] = 0.f;
    } else {
      int64_t* row =
          static_cast<int64_t*>(out) + i * static_cast<size_t>(maxlen);
      memcpy(row, ds->ipool[slot].data() + ref.offset, n * sizeof(int64_t));
      for (uint32_t j = n; j < static_cast<uint32_t>(maxlen); ++j) row[j] = 0;
    }
  }
  return maxlen;
}

}  // extern "C"
