// Native feature-archive reader: mmap + multithreaded padded-batch fill.
//
// The port's own copy of the reader of the JAX package (the two stay byte
// for byte compatible on the format).  Training consumes padded (B, T_max,
// D) batches; building them in Python costs a per-utterance copy through
// the interpreter.  This library maps the archive once and fills padded
// batches (plus masks) with std::thread workers straight from the page
// cache.
//
// Format "BEER_AR1": see beer_tpu_torch/io/__init__.py (writer) for the
// layout.
//
// Build (done at first use by beer_tpu_torch.io, into beer_tpu_torch/_build):
//   g++ -O3 -shared -fPIC -std=c++17 -pthread archive.cpp -o libbeer_archive.so

#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct UttInfo {
  std::string id;
  uint64_t offset;      // byte offset of frame data from file start
  uint32_t n_frames;
  uint32_t dim;
};

struct Archive {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::vector<UttInfo> utts;
};

template <typename T>
T read_pod(const uint8_t*& p) {
  T value;
  std::memcpy(&value, p, sizeof(T));
  p += sizeof(T);
  return value;
}

}  // namespace

extern "C" {

void* bar_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* ar = new Archive;
  ar->fd = fd;
  ar->base = static_cast<const uint8_t*>(mem);
  ar->size = st.st_size;

  // Parse the index with bounds checks against the mapped size: a
  // truncated or corrupt .bar must fail bar_open, not read out of
  // bounds in here or later in bar_read_batch/bar_utt_data.
  const uint8_t* p = ar->base;
  const uint8_t* end = ar->base + ar->size;
  auto fail = [&]() -> void* {
    munmap(mem, st.st_size);
    ::close(fd);
    delete ar;
    return nullptr;
  };
  auto can_read = [&](size_t bytes) {
    return static_cast<size_t>(end - p) >= bytes;
  };
  if (ar->size < 16 || std::memcmp(p, "BEER_AR1", 8) != 0) return fail();
  p += 8;
  uint64_t n = read_pod<uint64_t>(p);
  if (n > ar->size / 20) return fail();  // each index entry is >= 20 bytes
  ar->utts.reserve(n);
  for (uint64_t i = 0; i < n; ++i) {
    if (!can_read(4)) return fail();
    uint32_t id_len = read_pod<uint32_t>(p);
    if (!can_read(static_cast<size_t>(id_len) + 16)) return fail();
    UttInfo info;
    info.id.assign(reinterpret_cast<const char*>(p), id_len);
    p += id_len;
    info.offset = read_pod<uint64_t>(p);
    info.n_frames = read_pod<uint32_t>(p);
    info.dim = read_pod<uint32_t>(p);
    const uint64_t nbytes =
        static_cast<uint64_t>(info.n_frames) * info.dim * sizeof(float);
    if (info.offset > ar->size || nbytes > ar->size - info.offset)
      return fail();
    // bar_read_batch copies frames * utts[0].dim from every utterance —
    // a mixed-dim archive would read past an utterance's data
    if (!ar->utts.empty() && info.dim != ar->utts[0].dim) return fail();
    ar->utts.push_back(std::move(info));
  }
  return ar;
}

void bar_close(void* handle) {
  auto* ar = static_cast<Archive*>(handle);
  if (!ar) return;
  munmap(const_cast<uint8_t*>(ar->base), ar->size);
  ::close(ar->fd);
  delete ar;
}

int64_t bar_num_utts(void* handle) {
  return static_cast<Archive*>(handle)->utts.size();
}

const char* bar_utt_id(void* handle, int64_t i) {
  return static_cast<Archive*>(handle)->utts[i].id.c_str();
}

int64_t bar_utt_frames(void* handle, int64_t i) {
  return static_cast<Archive*>(handle)->utts[i].n_frames;
}

int64_t bar_dim(void* handle) {
  auto* ar = static_cast<Archive*>(handle);
  return ar->utts.empty() ? 0 : ar->utts[0].dim;
}

const float* bar_utt_data(void* handle, int64_t i) {
  auto* ar = static_cast<Archive*>(handle);
  return reinterpret_cast<const float*>(ar->base + ar->utts[i].offset);
}

// Fill a padded batch: out (n, t_max, dim) zero-padded, mask (n, t_max).
// Copies run on `n_threads` workers straight from the mapped pages.
void bar_read_batch(void* handle, const int64_t* indices, int64_t n,
                    int64_t t_max, float* out, float* mask,
                    int64_t n_threads) {
  auto* ar = static_cast<Archive*>(handle);
  const int64_t dim = bar_dim(handle);
  std::memset(out, 0, sizeof(float) * n * t_max * dim);
  std::memset(mask, 0, sizeof(float) * n * t_max);

  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t b = begin; b < end; ++b) {
      const UttInfo& info = ar->utts[indices[b]];
      const int64_t frames =
          std::min<int64_t>(info.n_frames, t_max);
      std::memcpy(out + b * t_max * dim,
                  ar->base + info.offset,
                  sizeof(float) * frames * dim);
      float* mrow = mask + b * t_max;
      for (int64_t t = 0; t < frames; ++t) mrow[t] = 1.0f;
    }
  };

  if (n_threads <= 1 || n < 2) {
    worker(0, n);
    return;
  }
  const int64_t workers = std::min<int64_t>(n_threads, n);
  std::vector<std::thread> pool;
  const int64_t step = (n + workers - 1) / workers;
  for (int64_t w = 0; w < workers; ++w) {
    int64_t begin = w * step;
    int64_t end = std::min(begin + step, n);
    if (begin < end) pool.emplace_back(worker, begin, end);
  }
  for (auto& t : pool) t.join();
}

}  // extern "C"
