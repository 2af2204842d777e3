// Native scan loader + multithreaded prefetcher for the CAE-LO pipeline.
//
// Host-side replacement for the reference's data-loading parallelism:
// np.fromfile in 10 forked worker processes with Manager-list IPC
// (BatchPreprocess.py:51,157,215-225; PoseEstimation.py:91-119 uses 4 loader
// subprocesses purely to hide .mat IO latency).  Here the same overlap is a
// C++ thread pool inside the process: zero IPC, zero pickling, the GIL is
// released for the whole read, and scans land already padded in the
// fixed-size float32 layout the jitted pipeline consumes.
//
// C ABI (ctypes-friendly), see caelo_tpu/data/native_loader.py:
//   caelo_load_scan(path, out, max_points, n_cols) -> n_points (or -errno)
//   caelo_prefetch_create(paths, n_paths, max_points, n_cols, depth, threads)
//   caelo_prefetch_next(handle, out) -> n_points, -1 at end
//   caelo_prefetch_destroy(handle)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// Read one KITTI .bin scan (float32 x,y,z,reflectance rows) into a
// zero-padded (max_points, n_cols) buffer.  Returns the number of points
// kept (truncated at max_points) or a negative errno.
int load_scan_impl(const char* path, float* out, int max_points, int n_cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::memset(out, 0, sizeof(float) * size_t(max_points) * n_cols);
  size_t want = size_t(max_points) * n_cols;
  size_t got = std::fread(out, sizeof(float), want, f);
  // if the file has more points than capacity, consume (and drop) the rest
  std::fclose(f);
  return int(got / n_cols);
}

struct Item {
  int index;
  int n_points;
  std::vector<float> data;
};

struct Prefetcher {
  std::vector<std::string> paths;
  int max_points;
  int n_cols;
  size_t depth;

  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  // min-heap on index so frames are delivered strictly in order
  std::priority_queue<Item*, std::vector<Item*>,
                      bool (*)(Item*, Item*)> ready{
      [](Item* a, Item* b) { return a->index > b->index; }};
  std::atomic<int> next_to_read{0};
  int next_to_deliver = 0;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      int i = next_to_read.fetch_add(1);
      if (i >= int(paths.size()) || stop.load()) return;
      Item* it = new Item;
      it->index = i;
      it->data.resize(size_t(max_points) * n_cols);
      it->n_points =
          load_scan_impl(paths[i].c_str(), it->data.data(), max_points, n_cols);
      std::unique_lock<std::mutex> lk(mu);
      // bound memory: wait until the consumer catches up to within `depth`
      cv_push.wait(lk, [&] {
        return stop.load() || i < next_to_deliver + int(depth);
      });
      if (stop.load()) { delete it; return; }
      ready.push(it);
      cv_pop.notify_all();
    }
  }

  int next(float* out) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_to_deliver >= int(paths.size())) return -1;
    cv_pop.wait(lk, [&] {
      return stop.load() ||
             (!ready.empty() && ready.top()->index == next_to_deliver);
    });
    if (stop.load()) return -1;
    Item* it = ready.top();
    ready.pop();
    std::memcpy(out, it->data.data(),
                sizeof(float) * size_t(max_points) * n_cols);
    int n = it->n_points;
    delete it;
    ++next_to_deliver;
    cv_push.notify_all();
    return n;
  }

  ~Prefetcher() {
    stop.store(true);
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& t : workers) t.join();
    while (!ready.empty()) { delete ready.top(); ready.pop(); }
  }
};

}  // namespace

extern "C" {

int caelo_load_scan(const char* path, float* out, int max_points, int n_cols) {
  return load_scan_impl(path, out, max_points, n_cols);
}

void* caelo_prefetch_create(const char** paths, int n_paths, int max_points,
                            int n_cols, int depth, int n_threads) {
  auto* p = new Prefetcher;
  p->paths.reserve(n_paths);
  for (int i = 0; i < n_paths; ++i) p->paths.emplace_back(paths[i]);
  p->max_points = max_points;
  p->n_cols = n_cols;
  p->depth = depth > 0 ? depth : 4;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

int caelo_prefetch_next(void* handle, float* out) {
  return static_cast<Prefetcher*>(handle)->next(out);
}

void caelo_prefetch_destroy(void* handle) {
  delete static_cast<Prefetcher*>(handle);
}

}  // extern "C"
