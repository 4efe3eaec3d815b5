// Native data loader — threaded host-side input pipeline.
//
// autodist_tpu_torch's copy of autodist_tpu/native/dataloader/dataloader.cc
// (same ABI, same ADT1 format, same record order for a seed), built by
// autodist_tpu_torch/data/record_dataset.py at first use.
//
// TPU-native replacement for the input-pipeline muscle the reference
// borrows from TensorFlow's C++ runtime (tf.data iterators / queue runners;
// SURVEY §2.0 notes all native functionality in the reference is stock TF).
// Training on TPU is fed from the host: record files must be read,
// shuffled, and assembled into fixed-shape batches fast enough to hide
// behind device compute. Python threads cannot do this off the GIL; these
// worker threads can.
//
// Scope: fixed-size binary records (the "ADT1" format written by
// autodist_tpu.data.RecordFileWriter — field layout lives in a Python-side
// sidecar; C++ sees opaque record_bytes). Workers gather shuffled records
// into a ring of reusable batch buffers; delivery is in batch order, so a
// given seed yields one deterministic stream regardless of thread count.
//
// Exposed as a C ABI (built into libadt_dataloader.so) consumed via ctypes
// from autodist_tpu/data/record_dataset.py and, in this copy, from
// autodist_tpu_torch/data/record_dataset.py.
//
// File format ADT1:
//   magic  "ADT1"            4 bytes
//   n_records                uint64 LE
//   record_bytes             uint64 LE
//   payload                  n_records * record_bytes
//
// Semantics: infinite stream over the file; each epoch is a fresh
// permutation (xorshift64* seeded from (seed, epoch)); trailing records
// that don't fill a batch are dropped (TPU static shapes).
//
// Sharding (multi-host input): adl_open_sharded(shard_index, shard_count)
// restricts the stream to the strided record subset
// {i : i % shard_count == shard_index} — every process reads a DISJOINT
// 1/shard_count slice of the file instead of materializing the global
// batch everywhere. Same seed + different shard_index streams are
// disjoint by construction.

#include <fcntl.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <mutex>
#include <numeric>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<uint8_t> data;
  uint64_t batch_index = 0;  // which global batch this slot holds
  bool ready = false;        // filled by a worker, not yet consumed
  bool in_use = false;       // handed to the consumer, not yet released
};

uint64_t XorShift(uint64_t* s) {
  uint64_t x = *s;
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  *s = x;
  return x * 0x2545F4914F6CDD1DULL;
}

struct Loader {
  // immutable after open
  int fd = -1;
  const uint8_t* base = nullptr;  // mmap of the payload
  size_t map_len = 0;
  uint64_t n_records = 0;      // records in THIS shard's universe
  uint64_t record_bytes = 0;
  uint64_t batch = 0;
  uint64_t batches_per_epoch = 0;
  int shuffle = 0;
  uint64_t seed = 0;
  uint64_t shard_index = 0;    // global record = local * shard_count + index
  uint64_t shard_count = 1;

  // epoch state (guarded by mu)
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for its batch
  std::condition_variable cv_free;    // workers wait for a free slot
  std::vector<Slot> ring;
  std::vector<uint32_t> perm;         // current epoch's permutation
  uint64_t perm_epoch = ~0ULL;        // epoch `perm` belongs to
  uint64_t next_claim = 0;            // next global batch index to fill
  uint64_t next_deliver = 0;          // next global batch index to hand out
  bool stopping = false;

  std::vector<std::thread> workers;

  void EnsurePermLocked(uint64_t epoch) {
    if (perm_epoch == epoch) return;
    perm.resize(n_records);
    std::iota(perm.begin(), perm.end(), 0u);
    if (shuffle) {
      uint64_t s = seed * 0x9E3779B97F4A7C15ULL + epoch + 1;
      for (uint64_t i = n_records - 1; i > 0; --i) {
        uint64_t j = XorShift(&s) % (i + 1);
        std::swap(perm[i], perm[j]);
      }
    }
    perm_epoch = epoch;
  }

  void WorkerLoop() {
    std::vector<uint32_t> indices(batch);
    std::vector<uint8_t> staging(batch * record_bytes);
    for (;;) {
      uint64_t my_batch;
      {
        std::unique_lock<std::mutex> lk(mu);
        my_batch = next_claim++;
        uint64_t epoch = my_batch / batches_per_epoch;
        uint64_t in_epoch = my_batch % batches_per_epoch;
        // workers never run more than one epoch ahead of the permutation
        // they need; EnsurePermLocked regenerates when the epoch advances.
        // A worker claiming a batch of epoch E while another still fills
        // E-1 is fine: indices are copied out under the lock.
        EnsurePermLocked(epoch);
        for (uint64_t k = 0; k < batch; ++k)
          indices[k] = perm[in_epoch * batch + k];
        if (stopping) return;
      }
      // gather outside the lock: this is the expensive part
      for (uint64_t k = 0; k < batch; ++k) {
        uint64_t g = (uint64_t)indices[k] * shard_count + shard_index;
        memcpy(staging.data() + k * record_bytes,
               base + g * record_bytes, record_bytes);
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        Slot* slot = &ring[my_batch % ring.size()];
        cv_free.wait(lk, [&] {
          return stopping || (!slot->ready && !slot->in_use &&
                              // slot's previous tenant must be delivered
                              my_batch < next_deliver + ring.size());
        });
        if (stopping) return;
        slot->data.swap(staging);
        slot->batch_index = my_batch;
        slot->ready = true;
        if (staging.size() != batch * record_bytes)
          staging.resize(batch * record_bytes);
        cv_ready.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns a handle, or null on error (message to stderr).
void* adl_open_sharded(const char* path, uint64_t batch, int shuffle,
                       uint64_t seed, int num_threads, uint64_t ring_slots,
                       uint64_t shard_index, uint64_t shard_count) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    perror("adl_open");
    return nullptr;
  }
  uint8_t header[20];
  if (read(fd, header, 20) != 20 || memcmp(header, "ADT1", 4) != 0) {
    fprintf(stderr, "adl_open: %s is not an ADT1 record file\n", path);
    close(fd);
    return nullptr;
  }
  uint64_t n_records, record_bytes;
  memcpy(&n_records, header + 4, 8);
  memcpy(&record_bytes, header + 12, 8);
  if (batch == 0) {
    fprintf(stderr, "adl_open: batch must be > 0\n");
    close(fd);
    return nullptr;
  }
  if (shard_count == 0 || shard_index >= shard_count) {
    fprintf(stderr, "adl_open: shard %llu/%llu invalid\n",
            (unsigned long long)shard_index, (unsigned long long)shard_count);
    close(fd);
    return nullptr;
  }
  uint64_t n_global = n_records;
  // this shard's universe: strided records {i : i % count == index}
  n_records = n_global / shard_count +
              (shard_index < n_global % shard_count ? 1 : 0);
  if (n_records < batch) {
    fprintf(stderr, "adl_open: batch %llu > records %llu (shard %llu/%llu)\n",
            (unsigned long long)batch, (unsigned long long)n_records,
            (unsigned long long)shard_index, (unsigned long long)shard_count);
    close(fd);
    return nullptr;
  }
  if (n_records > UINT32_MAX) {
    // the epoch permutation stores uint32 indices; silently wrapping would
    // sample the wrong records
    fprintf(stderr,
            "adl_open: n_records %llu exceeds 2^32-1 (perm index width)\n",
            (unsigned long long)n_records);
    close(fd);
    return nullptr;
  }
  struct stat st;
  fstat(fd, &st);
  if (record_bytes == 0 ||
      n_global > (SIZE_MAX - 20) / record_bytes) {  // corrupt header
    fprintf(stderr, "adl_open: %s header overflows (n=%llu rb=%llu)\n", path,
            (unsigned long long)n_global, (unsigned long long)record_bytes);
    close(fd);
    return nullptr;
  }
  size_t want = 20 + n_global * record_bytes;  // the FULL file is mapped
  if ((size_t)st.st_size < want) {
    fprintf(stderr, "adl_open: %s truncated (%lld < %zu)\n", path,
            (long long)st.st_size, want);
    close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, want, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    perror("adl_open: mmap");
    close(fd);
    return nullptr;
  }
  auto* L = new Loader();
  L->fd = fd;
  L->base = (const uint8_t*)map + 20;
  L->map_len = want;
  L->n_records = n_records;
  L->record_bytes = record_bytes;
  L->batch = batch;
  L->batches_per_epoch = n_records / batch;
  L->shuffle = shuffle;
  L->seed = seed;
  L->shard_index = shard_index;
  L->shard_count = shard_count;
  if (ring_slots < 2) ring_slots = 2;
  L->ring.resize(ring_slots);
  if (num_threads < 1) num_threads = 1;
  for (int i = 0; i < num_threads; ++i)
    L->workers.emplace_back([L] { L->WorkerLoop(); });
  return L;
}

void* adl_open(const char* path, uint64_t batch, int shuffle, uint64_t seed,
               int num_threads, uint64_t ring_slots) {
  return adl_open_sharded(path, batch, shuffle, seed, num_threads, ring_slots,
                          0, 1);
}

uint64_t adl_record_bytes(void* h) { return ((Loader*)h)->record_bytes; }
uint64_t adl_num_records(void* h) { return ((Loader*)h)->n_records; }
uint64_t adl_batches_per_epoch(void* h) {
  return ((Loader*)h)->batches_per_epoch;
}

// Blocks until the next in-order batch is ready; returns its buffer (valid
// until adl_release_batch) and writes the global batch index.
const uint8_t* adl_next_batch(void* h, uint64_t* batch_index_out) {
  auto* L = (Loader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  uint64_t want = L->next_deliver;
  Slot* slot = &L->ring[want % L->ring.size()];
  L->cv_ready.wait(lk, [&] {
    return L->stopping || (slot->ready && slot->batch_index == want);
  });
  if (L->stopping) return nullptr;
  slot->ready = false;
  slot->in_use = true;
  L->next_deliver = want + 1;
  if (batch_index_out) *batch_index_out = want;
  return slot->data.data();
}

void adl_release_batch(void* h, uint64_t batch_index) {
  auto* L = (Loader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  Slot* slot = &L->ring[batch_index % L->ring.size()];
  slot->in_use = false;
  L->cv_free.notify_all();
}

void adl_close(void* h) {
  auto* L = (Loader*)h;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->stopping = true;
    L->cv_ready.notify_all();
    L->cv_free.notify_all();
  }
  for (auto& t : L->workers) t.join();
  munmap((void*)(L->base - 20), L->map_len);
  close(L->fd);
  delete L;
}

}  // extern "C"
