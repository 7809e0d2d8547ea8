// Native threaded batch loader for fixed-record datasets (host C++).
//
// Host-side input pipeline of the port's trainers and servers, the copy of
// the JAX package's equiadapt_tpu/native/batch_loader.cc: the reference
// feeds its models through torch DataLoader worker *processes* (e.g.
// num_workers=11, reference examples/nbody/prepare/nbody_data.py:241); this
// is the native-thread equivalent. It memory-maps a binary file of
// fixed-size records, shuffles indices per epoch (SplitMix64), and
// assembles batches into caller-provided buffers on a pool of worker
// threads with a bounded prefetch queue, overlapping host batch assembly
// with device steps.
//
// C ABI (ctypes-consumed, see equiadapt_tpu_torch/native/loader.py):
//   void* eqt_loader_create(const char* path, long record_bytes,
//                           long num_records, long batch_size,
//                           int num_threads, int prefetch_depth,
//                           unsigned long long seed, int shuffle);
//   long  eqt_loader_next(void* loader, void* out);   // blocks; returns
//                                                     // batch index or -1
//   void  eqt_loader_destroy(void* loader);
//
// Built with the host C++ compiler at first use, into
// equiadapt_tpu_torch/_build/ under a name carrying this file's hash
// (native/loader.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

struct Batch {
  int64_t index;
  std::vector<uint8_t> data;
};

class Loader {
 public:
  Loader(const char* path, int64_t record_bytes, int64_t num_records,
         int64_t batch_size, int num_threads, int prefetch_depth,
         uint64_t seed, bool shuffle)
      : record_bytes_(record_bytes),
        num_records_(num_records),
        batch_size_(batch_size),
        prefetch_depth_(prefetch_depth < 1 ? 2 : prefetch_depth),
        seed_(seed),
        shuffle_(shuffle) {
    fd_ = open(path, O_RDONLY);
    if (fd_ >= 0) {
      size_t bytes = static_cast<size_t>(record_bytes_) * num_records_;
      base_ = static_cast<uint8_t*>(
          mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd_, 0));
      if (base_ == MAP_FAILED) base_ = nullptr;
      ok_ = base_ != nullptr;
      if (ok_) madvise(base_, bytes, MADV_WILLNEED);
    }
    if (!ok_) return;
    reshuffle(0);
    int n = num_threads < 1 ? 1 : num_threads;
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { worker_loop(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : workers_) t.join();
    if (base_) munmap(base_, static_cast<size_t>(record_bytes_) * num_records_);
    if (fd_ >= 0) close(fd_);
  }

  bool ok() const { return ok_; }

  // Blocks until the next in-order batch is assembled; copies it into out.
  int64_t next(void* out) {
    std::unique_lock<std::mutex> lk(mu_);
    int64_t want = next_consume_++;
    cv_ready_.wait(lk, [&] {
      if (stop_) return true;
      for (auto& b : ready_)
        if (b.index == want) return true;
      return false;
    });
    if (stop_) return -1;
    for (auto it = ready_.begin(); it != ready_.end(); ++it) {
      if (it->index == want) {
        std::memcpy(out, it->data.data(), it->data.size());
        ready_.erase(it);
        cv_space_.notify_all();
        return want;
      }
    }
    return -1;
  }

 private:
  void reshuffle(uint64_t epoch) {
    order_.resize(num_records_);
    for (int64_t i = 0; i < num_records_; ++i) order_[i] = i;
    if (shuffle_) {
      uint64_t s = seed_ + 0x9e3779b9ull * (epoch + 1);
      for (int64_t i = num_records_ - 1; i > 0; --i) {
        int64_t j = static_cast<int64_t>(splitmix64(s) % (i + 1));
        std::swap(order_[i], order_[j]);
      }
    }
  }

  void worker_loop() {
    for (;;) {
      int64_t my_batch;
      // This batch's record indices, snapshotted from order_ inside the
      // claim critical section: reshuffle() rewrites order_ when a worker
      // claims the first batch of the next epoch, so the (unlocked) copy
      // loop below must never read shared mutable state, and the snapshot
      // must happen before any later claim can trigger that reshuffle.
      std::vector<int64_t> recs(static_cast<size_t>(batch_size_));
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [&] {
          return stop_ ||
                 static_cast<int>(ready_.size()) + in_flight_ < prefetch_depth_;
        });
        if (stop_) return;
        my_batch = next_produce_++;
        ++in_flight_;
        // epoch boundary: reshuffle deterministically
        int64_t per_epoch = num_records_ / batch_size_;
        if (per_epoch > 0 && my_batch % per_epoch == 0)
          reshuffle(static_cast<uint64_t>(my_batch / per_epoch));
        int64_t in_epoch = per_epoch > 0 ? my_batch % per_epoch : 0;
        for (int64_t k = 0; k < batch_size_; ++k)
          recs[static_cast<size_t>(k)] =
              order_[(in_epoch * batch_size_ + k) % num_records_];
      }
      Batch b;
      b.index = my_batch;
      b.data.resize(static_cast<size_t>(batch_size_) * record_bytes_);
      for (int64_t k = 0; k < batch_size_; ++k) {
        std::memcpy(b.data.data() + k * record_bytes_,
                    base_ + recs[static_cast<size_t>(k)] * record_bytes_,
                    static_cast<size_t>(record_bytes_));
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        ready_.push_back(std::move(b));
        --in_flight_;
      }
      cv_ready_.notify_all();
    }
  }

  int fd_ = -1;
  uint8_t* base_ = nullptr;
  bool ok_ = false;
  int64_t record_bytes_, num_records_, batch_size_;
  int prefetch_depth_;
  uint64_t seed_;
  bool shuffle_;
  std::vector<int64_t> order_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_space_, cv_ready_;
  std::deque<Batch> ready_;
  int in_flight_ = 0;
  int64_t next_produce_ = 0;
  int64_t next_consume_ = 0;
  bool stop_ = false;
};

}  // namespace

extern "C" {

void* eqt_loader_create(const char* path, long record_bytes, long num_records,
                        long batch_size, int num_threads, int prefetch_depth,
                        unsigned long long seed, int shuffle) {
  auto* l = new Loader(path, record_bytes, num_records, batch_size,
                       num_threads, prefetch_depth, seed, shuffle != 0);
  if (!l->ok()) {
    delete l;
    return nullptr;
  }
  return l;
}

long eqt_loader_next(void* loader, void* out) {
  return static_cast<long>(static_cast<Loader*>(loader)->next(out));
}

void eqt_loader_destroy(void* loader) { delete static_cast<Loader*>(loader); }

}  // extern "C"
