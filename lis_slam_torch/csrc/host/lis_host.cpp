// Native host runtime for the TPU SLAM engine.
//
// Plays the role of the reference's host-side plumbing (ROS message
// ingestion + the mutex-guarded std::deque queues with drop-beyond-20
// backpressure, laserProcessing.cpp:4-12 / subMapOptmizationNode.cpp:739,
// and the rosbag ingestion path): a multithreaded scan prefetcher reading
// KITTI .bin files into pre-padded pinned buffers, a fixed-capacity ring
// queue, plus a couple of host-side point-cloud kernels (range gating,
// voxel filter) so the Python driver never touches raw file IO in the hot
// loop.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// .bin reading
// ---------------------------------------------------------------------------

// Reads a KITTI velodyne .bin (float32 x,y,z,intensity) into out (capacity
// max_points*4 floats). Returns number of points read, or -1 on error.
int64_t lis_read_bin(const char* path, float* out, int64_t max_points) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t n = fread(out, sizeof(float) * 4, (size_t)max_points, f);
  fclose(f);
  return n;
}

// Range-gate + NaN filter in place (removeClosedPointCloud equivalent,
// laserPretreatment.h:25-54). Compacts valid points to the front; returns
// new count.
int64_t lis_range_filter(float* pts, int64_t n, float min_range,
                         float max_range) {
  int64_t w = 0;
  const float min2 = min_range * min_range;
  const float max2 = max_range * max_range;
  for (int64_t i = 0; i < n; ++i) {
    const float x = pts[i * 4 + 0];
    const float y = pts[i * 4 + 1];
    const float z = pts[i * 4 + 2];
    const float inten = pts[i * 4 + 3];
    if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z)) continue;
    const float r2 = x * x + y * y + z * z;
    if (r2 < min2 || r2 > max2 || r2 < 1e-6f) continue;
    pts[w * 4 + 0] = x;
    pts[w * 4 + 1] = y;
    pts[w * 4 + 2] = z;
    pts[w * 4 + 3] = inten;
    ++w;
  }
  return w;
}

// Host voxel filter (first point per voxel) for map export paths. Returns
// kept count; writes compacted points into out.
int64_t lis_voxel_filter(const float* pts, int64_t n, float leaf, float* out,
                         int64_t max_out) {
  std::unordered_map<uint64_t, char> seen;
  seen.reserve((size_t)n);
  int64_t w = 0;
  const float inv = 1.0f / leaf;
  for (int64_t i = 0; i < n && w < max_out; ++i) {
    const int64_t cx = (int64_t)std::floor(pts[i * 3 + 0] * inv) + (1 << 20);
    const int64_t cy = (int64_t)std::floor(pts[i * 3 + 1] * inv) + (1 << 20);
    const int64_t cz = (int64_t)std::floor(pts[i * 3 + 2] * inv) + (1 << 20);
    const uint64_t key = ((uint64_t)cx << 42) | ((uint64_t)cy << 21) |
                         (uint64_t)cz;
    auto it = seen.emplace(key, 1);
    if (it.second) {
      out[w * 3 + 0] = pts[i * 3 + 0];
      out[w * 3 + 1] = pts[i * 3 + 1];
      out[w * 3 + 2] = pts[i * 3 + 2];
      ++w;
    }
  }
  return w;
}

// ---------------------------------------------------------------------------
// Async scan prefetcher: worker threads read .bin files ahead of the
// consumer; fixed-capacity queue with blocking backpressure.
// ---------------------------------------------------------------------------

struct Scan {
  std::vector<float> data;  // padded (max_points, 4)
  int64_t count = 0;
  int64_t index = -1;
};

struct Loader {
  std::vector<std::string> files;
  int64_t max_points = 0;
  size_t capacity = 0;
  float min_range = 0.0f, max_range = 1e9f;

  std::queue<Scan> queue;
  std::mutex mu;
  std::condition_variable cv_pop, cv_push;
  std::atomic<int64_t> next_file{0};
  std::atomic<bool> stop{false};
  std::atomic<int64_t> dropped{0};
  std::vector<std::thread> workers;
  std::atomic<int64_t> completed{0};  // files fully read + enqueued
  std::atomic<int64_t> popped{0};

  void worker() {
    while (!stop.load()) {
      const int64_t idx = next_file.fetch_add(1);
      if (idx >= (int64_t)files.size()) break;
      Scan s;
      s.data.resize((size_t)max_points * 4, 0.0f);
      int64_t n = lis_read_bin(files[idx].c_str(), s.data.data(), max_points);
      if (n < 0) n = 0;
      n = lis_range_filter(s.data.data(), n, min_range, max_range);
      std::memset(s.data.data() + n * 4, 0,
                  sizeof(float) * 4 * (size_t)(max_points - n));
      s.count = n;
      s.index = idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return queue.size() < capacity || stop.load(); });
        if (stop.load()) break;
        queue.push(std::move(s));
        completed.fetch_add(1);
      }
      cv_pop.notify_one();
    }
  }
};

void* lis_loader_create(const char** paths, int64_t n_files,
                        int64_t max_points, int64_t capacity,
                        int64_t n_threads, float min_range, float max_range) {
  auto* L = new Loader();
  L->files.assign(paths, paths + n_files);
  L->max_points = max_points;
  L->capacity = (size_t)capacity;
  L->min_range = min_range;
  L->max_range = max_range;
  for (int64_t i = 0; i < n_threads; ++i)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Pops the next scan (in file order is NOT guaranteed across threads; the
// consumer reorders by the returned index). Returns count, -1 when
// exhausted. out must hold max_points*4 floats.
int64_t lis_loader_pop(void* handle, float* out, int64_t* index) {
  auto* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_pop.wait(lk, [&] {
    return !L->queue.empty() ||
           L->completed.load() >= (int64_t)L->files.size() || L->stop.load();
  });
  if (L->queue.empty()) return -1;
  Scan s = std::move(L->queue.front());
  L->queue.pop();
  lk.unlock();
  L->popped.fetch_add(1);
  L->cv_push.notify_one();
  std::memcpy(out, s.data.data(), sizeof(float) * 4 * (size_t)L->max_points);
  *index = s.index;
  return s.count;
}

int64_t lis_loader_remaining(void* handle) {
  auto* L = (Loader*)handle;
  return (int64_t)L->files.size() - L->popped.load();
}

void lis_loader_destroy(void* handle) {
  auto* L = (Loader*)handle;
  L->stop.store(true);
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
