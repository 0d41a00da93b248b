// Native RecordIO reader and threaded prefetching batchers of the
// PyTorch port (mxnet_tpu_torch/io/native.py binds them with ctypes).
//
// Port of the record side of mxnet_tpu's src/cc/recordio.cc and
// src/cc/image_batcher.cc: dmlc RecordIO framing (0xced7230a magic,
// cflag/length control word, 4-byte alignment), the .idx index, the
// shuffle (std::mt19937_64 seeded seed + epoch, as there) and the
// num_parts/part_index split run on C++ threads. No image is decoded
// here and no jpeglib is linked: the image batcher hands each batch's
// JPEG streams and labels to Python, which decodes them on the card
// with nvJPEG (ops/image.py) or, on the CPU, with PIL.
//
// Image records (python recordio.pack_img): IRHeader "<IfQQ" = {flag:
// u32, label: f32, id: u64, id2: u64}; flag > 0 means `flag` float32
// labels follow the header (the first is the label); the JPEG stream
// follows. A record too short for its header, or with no image bytes,
// is skipped and the batch compacted, as the JAX batcher does.
//
// C ABI:
//   mxio_reader_open / _next / _close
//   mxio_batcher_create (raw records, the last batch kept short) or
//   mxrec_img_create (JPEG streams and labels, the last partial batch
//   discarded), then mxio_batcher_num_batches / _next / _free_batch /
//   _reset / _close for either

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kLenBits = 29;
constexpr uint32_t kLenMask = (1u << kLenBits) - 1;
constexpr size_t kHeaderSize = 4 + 4 + 8 + 8;

struct Reader {
  std::FILE* f = nullptr;
  std::vector<char> buf;
};

bool ReadRecord(std::FILE* f, std::vector<char>* out) {
  out->clear();
  uint32_t hdr[2];
  for (;;) {
    if (std::fread(hdr, sizeof(uint32_t), 2, f) != 2) return false;
    if (hdr[0] != kMagic) return false;
    uint32_t cflag = hdr[1] >> kLenBits;
    uint32_t len = hdr[1] & kLenMask;
    size_t pos = out->size();
    out->resize(pos + len);
    if (len && std::fread(out->data() + pos, 1, len, f) != len) return false;
    uint32_t pad = (4 - (len % 4)) % 4;
    if (pad) std::fseek(f, pad, SEEK_CUR);
    // cflag: 0 whole, 1 begin, 2 middle, 3 end
    if (cflag == 0 || cflag == 3) return true;
  }
}

struct Batch {
  std::vector<char> data;        // concatenated payloads (JPEG streams)
  std::vector<int64_t> offsets;  // size = n+1
  std::vector<float> labels;     // image batches: one a record
};

// One batcher for both kinds: raw records (image = false: every
// record's payload, the last batch kept short) and image records
// (image = true: the JPEG stream and label of each valid record, the
// last partial batch discarded).
struct Batcher {
  std::string path;
  std::vector<int64_t> index;   // byte offsets of records
  std::vector<int64_t> order;   // iteration order (may be shuffled)
  size_t batch_size = 1;
  bool image = false;
  bool shuffle = false;
  uint64_t seed = 0;
  size_t epoch = 0;
  size_t prefetch = 4;
  int num_threads = 2;

  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::deque<Batch*> ready;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  size_t next_batch_id = 0;       // batch id to hand to a worker
  size_t emit_batch_id = 0;       // batch id the consumer expects
  std::deque<std::pair<size_t, Batch*>> out_of_order;

  ~Batcher() { Shutdown(); }

  void Shutdown() {
    stop.store(true);
    cv_produce.notify_all();
    cv_consume.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    for (auto* b : ready) delete b;
    ready.clear();
    for (auto& p : out_of_order) delete p.second;
    out_of_order.clear();
  }

  size_t NumBatches() const {
    if (image) return order.size() / batch_size;  // last_batch='discard'
    return (order.size() + batch_size - 1) / batch_size;
  }

  void StartEpoch() {
    Shutdown();
    stop.store(false);
    if (shuffle) {
      std::mt19937_64 rng(seed + epoch);
      std::shuffle(order.begin(), order.end(), rng);
    }
    next_batch_id = 0;
    emit_batch_id = 0;
    for (int i = 0; i < num_threads; ++i)
      workers.emplace_back([this] { WorkerLoop(); });
  }

  // The image record's JPEG stream and label into the batch; false
  // when the record is too short or holds no image bytes.
  static bool AddImage(const std::vector<char>& rec, Batch* b) {
    if (rec.size() < kHeaderSize) return false;
    uint32_t flag;
    float label;
    std::memcpy(&flag, rec.data(), 4);
    std::memcpy(&label, rec.data() + 4, 4);
    size_t img_off = kHeaderSize + (flag > 0 ? flag * 4ul : 0);
    if (flag > 0)  // multi-label: the first
      std::memcpy(&label, rec.data() + kHeaderSize, 4);
    if (img_off >= rec.size()) return false;
    b->data.insert(b->data.end(), rec.begin() + img_off, rec.end());
    b->offsets.push_back(static_cast<int64_t>(b->data.size()));
    b->labels.push_back(label);
    return true;
  }

  void WorkerLoop() {
    std::FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) {
      // wake a blocked consumer instead of leaving it waiting
      stop.store(true);
      cv_consume.notify_all();
      cv_produce.notify_all();
      return;
    }
    std::vector<char> rec;
    while (!stop.load()) {
      size_t my_batch;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_produce.wait(lk, [this] {
          return stop.load() || (next_batch_id < NumBatches() &&
                                 ready.size() + out_of_order.size() < prefetch);
        });
        if (stop.load() || next_batch_id >= NumBatches()) break;
        my_batch = next_batch_id++;
      }
      auto* b = new Batch();
      b->offsets.push_back(0);
      size_t begin = my_batch * batch_size;
      size_t end = std::min(begin + batch_size, order.size());
      for (size_t i = begin; i < end; ++i) {
        std::fseek(f, static_cast<long>(index[order[i]]), SEEK_SET);
        if (!ReadRecord(f, &rec)) {
          if (image) continue;  // a corrupt record is skipped
          break;
        }
        if (image) {
          AddImage(rec, b);
          continue;
        }
        b->data.insert(b->data.end(), rec.begin(), rec.end());
        b->offsets.push_back(static_cast<int64_t>(b->data.size()));
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        out_of_order.emplace_back(my_batch, b);
        // drain contiguously-ordered batches into the ready queue so
        // the consumer sees the batches in order, whatever order the
        // workers finish them in
        bool moved = true;
        while (moved) {
          moved = false;
          for (auto it = out_of_order.begin(); it != out_of_order.end(); ++it) {
            if (it->first == emit_batch_id + ready.size()) {
              ready.push_back(it->second);
              out_of_order.erase(it);
              moved = true;
              break;
            }
          }
        }
        cv_consume.notify_all();
      }
    }
    std::fclose(f);
  }

  Batch* Next() {
    std::unique_lock<std::mutex> lk(mu);
    cv_consume.wait(lk, [this] {
      return stop.load() || !ready.empty() ||
             (emit_batch_id >= NumBatches());
    });
    if (ready.empty()) return nullptr;  // epoch done
    Batch* b = ready.front();
    ready.pop_front();
    ++emit_batch_id;
    cv_produce.notify_all();
    return b;
  }
};

std::vector<int64_t> BuildIndexFromIdx(const std::string& idx_path) {
  std::vector<int64_t> out;
  std::ifstream in(idx_path);
  std::string line;
  while (std::getline(in, line)) {
    auto tab = line.find('\t');
    if (tab == std::string::npos) continue;
    out.push_back(std::stoll(line.substr(tab + 1)));
  }
  return out;
}

std::vector<int64_t> BuildIndexByScan(const std::string& path) {
  std::vector<int64_t> out;
  std::FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return out;
  std::vector<char> rec;
  for (;;) {
    long pos = std::ftell(f);
    if (!ReadRecord(f, &rec)) break;
    out.push_back(pos);
  }
  std::fclose(f);
  return out;
}

Batcher* NewBatcher(const char* rec_path, const char* idx_path,
                    int64_t batch_size, int num_threads, int shuffle,
                    uint64_t seed, int64_t num_parts, int64_t part_index,
                    bool image) {
  auto* b = new Batcher();
  b->path = rec_path;
  b->image = image;
  b->batch_size = static_cast<size_t>(batch_size > 0 ? batch_size : 1);
  b->num_threads = num_threads > 0 ? num_threads : (image ? 4 : 2);
  b->prefetch = image ? 6 : 4;
  b->shuffle = shuffle != 0;
  b->seed = seed;
  // the .rec must open now: a stale .idx pointing at a moved file fails
  // here, not in the first next()
  std::FILE* probe = std::fopen(rec_path, "rb");
  if (!probe) {
    delete b;
    return nullptr;
  }
  std::fclose(probe);
  b->index = (idx_path && idx_path[0]) ? BuildIndexFromIdx(idx_path)
                                       : BuildIndexByScan(rec_path);
  if (b->index.empty()) {
    delete b;
    return nullptr;
  }
  // dataset sharding for multi-worker training (num_parts/part_index,
  // the reference ImageRecordIter's arguments)
  for (size_t i = part_index < 0 ? 0 : static_cast<size_t>(part_index);
       i < b->index.size();
       i += (num_parts > 1 ? static_cast<size_t>(num_parts) : 1)) {
    b->order.push_back(static_cast<int64_t>(i));
  }
  if (image && b->order.size() < b->batch_size) {
    delete b;
    return nullptr;
  }
  b->StartEpoch();
  return b;
}

}  // namespace

extern "C" {

void* mxio_reader_open(const char* path) {
  auto* r = new Reader();
  r->f = std::fopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  return r;
}

// returns the record's length, or -1 at EOF; *buf points at internal
// storage valid until the next call
int64_t mxio_reader_next(void* handle, const char** buf) {
  auto* r = static_cast<Reader*>(handle);
  if (!ReadRecord(r->f, &r->buf)) return -1;
  *buf = r->buf.data();
  return static_cast<int64_t>(r->buf.size());
}

void mxio_reader_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (r->f) std::fclose(r->f);
  delete r;
}

void* mxio_batcher_create(const char* rec_path, const char* idx_path,
                          int64_t batch_size, int num_threads, int shuffle,
                          uint64_t seed, int64_t num_parts,
                          int64_t part_index) {
  return NewBatcher(rec_path, idx_path, batch_size, num_threads, shuffle,
                    seed, num_parts, part_index, false);
}

void* mxrec_img_create(const char* rec_path, const char* idx_path,
                       int64_t batch_size, int num_threads, int shuffle,
                       uint64_t seed, int64_t num_parts, int64_t part_index) {
  return NewBatcher(rec_path, idx_path, batch_size, num_threads, shuffle,
                    seed, num_parts, part_index, true);
}

int64_t mxio_batcher_num_batches(void* handle) {
  return static_cast<int64_t>(static_cast<Batcher*>(handle)->NumBatches());
}

// Returns the number of records in the batch, or -1 at the epoch's end
// (an image batch may hold 0 when every record was skipped). The caller
// frees the batch with mxio_batcher_free_batch; data, offsets and
// labels (image batches) are owned by it.
int64_t mxio_batcher_next(void* handle, void** batch_out, const char** data,
                          const int64_t** offsets, const float** labels) {
  auto* b = static_cast<Batcher*>(handle);
  Batch* batch = b->Next();
  if (!batch) return -1;
  *batch_out = batch;
  *data = batch->data.data();
  *offsets = batch->offsets.data();
  *labels = batch->labels.data();
  return static_cast<int64_t>(batch->offsets.size()) - 1;
}

void mxio_batcher_free_batch(void* batch) {
  delete static_cast<Batch*>(batch);
}

void mxio_batcher_reset(void* handle) {
  auto* b = static_cast<Batcher*>(handle);
  ++b->epoch;
  b->StartEpoch();
}

void mxio_batcher_close(void* handle) { delete static_cast<Batcher*>(handle); }

}  // extern "C"
