// slamio — native host runtime for the stereo-visual-SLAM framework.
//
// The reference system's entire runtime is native C++ (a ROS node:
// run_vslam.cpp driving OpenCV imread at visual_odometry.cpp:37-68 and a
// trajectory writer at map.cpp:168-204). This build keeps the compute
// path in JAX/XLA; this library is the native equivalent of the
// reference's host-side runtime:
//
//   * grayscale image decode (PNG via libpng, PGM natively) — replaces
//     cv::imread(..., IMREAD_GRAYSCALE) of visual_odometry.cpp:50-51;
//   * a multithreaded prefetching stereo-frame loader with a bounded ring
//     buffer — the async IO executor that keeps the device fed (the reference
//     reads synchronously inside the hot loop; we overlap decode with
//     device compute);
//   * a KITTI-format trajectory writer emitting the exact row layout of
//     Map::write_pose (map.cpp:188-195): "frame_id r00 r01 r02 x ... z" of
//     T_w_c = T_c_w^-1.
//
// C ABI throughout — consumed from Python via ctypes (no pybind11 in the
// image). All functions return 0 / non-negative on success, negative on
// error.

#include <png.h>

#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#define SIO_API extern "C" __attribute__((visibility("default")))

namespace {

// ---------------------------------------------------------------------------
// Image decode
// ---------------------------------------------------------------------------

struct GrayImage {
  int h = 0;
  int w = 0;
  std::vector<uint8_t> pix;
};

bool decode_png_gray(FILE* fp, GrayImage* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  // Normalize everything to 8-bit single-channel gray (ITU-R 709 weights for
  // color inputs — KITTI odometry gray sequences are already single channel).
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE) {
    png_set_rgb_to_gray_fixed(png, 1 /*error_action: silent*/, -1, -1);
  }
  png_read_update_info(png, info);

  out->h = static_cast<int>(h);
  out->w = static_cast<int>(w);
  out->pix.resize(static_cast<size_t>(h) * w);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 r = 0; r < h; ++r)
    rows[r] = out->pix.data() + static_cast<size_t>(r) * w;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// Minimal binary PGM (P5) reader, 8-bit maxval.
bool decode_pgm_gray(FILE* fp, GrayImage* out) {
  auto skip_ws = [&]() {
    int c;
    while ((c = fgetc(fp)) != EOF) {
      if (c == '#') {
        while ((c = fgetc(fp)) != EOF && c != '\n') {
        }
      } else if (!std::isspace(c)) {
        ungetc(c, fp);
        return;
      }
    }
  };
  auto read_int = [&]() -> long {
    skip_ws();
    long v = 0;
    int c, any = 0;
    while ((c = fgetc(fp)) != EOF && std::isdigit(c)) {
      v = v * 10 + (c - '0');
      any = 1;
    }
    return any ? v : -1;
  };
  char magic[3] = {0, 0, 0};
  if (fread(magic, 1, 2, fp) != 2 || magic[0] != 'P' || magic[1] != '5')
    return false;
  long w = read_int(), h = read_int(), maxv = read_int();
  if (w <= 0 || h <= 0 || maxv <= 0 || maxv > 255) return false;
  out->h = static_cast<int>(h);
  out->w = static_cast<int>(w);
  out->pix.resize(static_cast<size_t>(h) * w);
  return fread(out->pix.data(), 1, out->pix.size(), fp) == out->pix.size();
}

bool read_gray(const char* path, GrayImage* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  uint8_t sig[8];
  size_t n = fread(sig, 1, 8, fp);
  rewind(fp);
  bool ok = false;
  if (n >= 8 && !png_sig_cmp(sig, 0, 8)) {
    ok = decode_png_gray(fp, out);
  } else if (n >= 2 && sig[0] == 'P' && sig[1] == '5') {
    ok = decode_pgm_gray(fp, out);
  }
  fclose(fp);
  return ok;
}

}  // namespace

SIO_API int sio_version() { return 1; }

// Probe image dimensions without (fully) decoding. -1: unreadable.
SIO_API int sio_probe_image(const char* path, int* h, int* w) {
  GrayImage img;
  if (!read_gray(path, &img)) return -1;
  *h = img.h;
  *w = img.w;
  return 0;
}

// Decode into caller buffer of capacity max_h*max_w. Returns 0, or -1 on
// decode failure, -2 if the image exceeds the buffer.
SIO_API int sio_read_image_gray(const char* path, uint8_t* out, int* h,
                                int* w, int max_h, int max_w) {
  GrayImage img;
  if (!read_gray(path, &img)) return -1;
  if (img.h > max_h || img.w > max_w) return -2;
  std::memcpy(out, img.pix.data(), img.pix.size());
  *h = img.h;
  *w = img.w;
  return 0;
}

// ---------------------------------------------------------------------------
// Prefetching stereo-frame loader
// ---------------------------------------------------------------------------
//
// N worker threads decode stereo pairs out of order into a bounded ring of
// `depth` slots; the consumer receives frames strictly in sequence order.
// A worker may only fill slot (frame % depth) once the consumer has drained
// frame-depth from it, enforced with per-ring condition variables.

namespace {

struct Slot {
  std::vector<uint8_t> left, right;
  int status = 0;  // 0 empty, 1 ready, -1 decode error
};

struct Prefetcher {
  std::string left_dir, right_dir, ext;
  int start = 0, count = 0, h = 0, w = 0, depth = 0;
  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for slot ready
  std::condition_variable cv_free;    // workers wait for slot drained
  std::atomic<int> next_to_fetch{0};  // next frame index a worker claims
  int next_to_consume = 0;            // guarded by mu
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  std::string frame_path(const std::string& dir, int idx) const {
    char name[32];
    std::snprintf(name, sizeof(name), "%06d", start + idx);
    return dir + "/" + name + ext;
  }

  void worker() {
    GrayImage li, ri;
    for (;;) {
      int idx = next_to_fetch.fetch_add(1);
      if (idx >= count || stop.load()) return;
      bool ok = read_gray(frame_path(left_dir, idx).c_str(), &li) &&
                read_gray(frame_path(right_dir, idx).c_str(), &ri) &&
                li.h == h && li.w == w && ri.h == h && ri.w == w;
      Slot& s = slots[idx % depth];
      std::unique_lock<std::mutex> lk(mu);
      // wait until the consumer has moved past frame idx-depth
      cv_free.wait(lk, [&] { return stop.load() || next_to_consume > idx - depth; });
      if (stop.load()) return;
      if (ok) {
        s.left.swap(li.pix);
        s.right.swap(ri.pix);
      }
      s.status = ok ? 1 : -1;
      cv_ready.notify_all();
    }
  }
};

}  // namespace

SIO_API void* sio_prefetch_open(const char* left_dir, const char* right_dir,
                                const char* ext, int start, int count, int h,
                                int w, int depth, int n_workers) {
  if (count <= 0 || h <= 0 || w <= 0) return nullptr;
  auto* p = new Prefetcher();
  p->left_dir = left_dir;
  p->right_dir = right_dir;
  p->ext = ext && ext[0] ? ext : ".png";
  p->start = start;
  p->count = count;
  p->h = h;
  p->w = w;
  p->depth = depth > 0 ? depth : 8;
  p->slots.resize(p->depth);
  int nw = n_workers > 0 ? n_workers : 4;
  if (nw > p->depth) nw = p->depth;
  for (int i = 0; i < nw; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Copy the next in-order stereo pair into caller buffers (h*w each).
// Returns the frame index (relative to start), -1 at end of sequence, -2 on
// decode error for that frame.
SIO_API int sio_prefetch_next(void* handle, uint8_t* left, uint8_t* right) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (!p || p->next_to_consume >= p->count) return -1;
  int idx;
  Slot* s;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    idx = p->next_to_consume;
    s = &p->slots[idx % p->depth];
    p->cv_ready.wait(lk, [&] { return s->status != 0; });
    int st = s->status;
    if (st == 1) {
      std::memcpy(left, s->left.data(), s->left.size());
      std::memcpy(right, s->right.data(), s->right.size());
    }
    s->status = 0;
    p->next_to_consume = idx + 1;
    p->cv_free.notify_all();
    if (st != 1) return -2;
  }
  return idx;
}

SIO_API void sio_prefetch_close(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (!p) return;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop.store(true);
  }
  p->cv_free.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

// ---------------------------------------------------------------------------
// Trajectory writer (KITTI rows, reference format of map.cpp:188-195)
// ---------------------------------------------------------------------------

namespace {
struct TrajWriter {
  FILE* fp = nullptr;
};
}  // namespace

SIO_API void* sio_traj_open(const char* path, int append) {
  FILE* fp = fopen(path, append ? "ab" : "wb");
  if (!fp) return nullptr;
  auto* t = new TrajWriter();
  t->fp = fp;
  return t;
}

// T_c_w: 16 doubles row-major (world->camera). Writes the row for
// T_w_c = T_c_w^-1 with 9 significant digits (matches the Python writer).
SIO_API int sio_traj_write(void* handle, long frame_id, const double* T_c_w) {
  auto* t = static_cast<TrajWriter*>(handle);
  if (!t || !t->fp) return -1;
  // closed-form inverse of a rigid transform: R' = R^T, t' = -R^T t
  double R[3][3], tr[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R[i][j] = T_c_w[4 * j + i];  // transpose
  for (int i = 0; i < 3; ++i)
    tr[i] = -(R[i][0] * T_c_w[3] + R[i][1] * T_c_w[7] + R[i][2] * T_c_w[11]);
  char buf[512];
  int n = std::snprintf(
      buf, sizeof(buf),
      "%ld %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g\n",
      frame_id, R[0][0], R[0][1], R[0][2], tr[0], R[1][0], R[1][1], R[1][2],
      tr[1], R[2][0], R[2][1], R[2][2], tr[2]);
  if (n <= 0 || fwrite(buf, 1, n, t->fp) != static_cast<size_t>(n)) return -1;
  return 0;
}

SIO_API int sio_traj_flush(void* handle) {
  auto* t = static_cast<TrajWriter*>(handle);
  return (t && t->fp && fflush(t->fp) == 0) ? 0 : -1;
}

SIO_API void sio_traj_close(void* handle) {
  auto* t = static_cast<TrajWriter*>(handle);
  if (!t) return;
  if (t->fp) fclose(t->fp);
  delete t;
}
