// mapstore — native arena-backed sliding-window keyframe/landmark map.
//
// The reference keeps its map in native C++ hash tables
// (Map, map.hpp:15-81; insert/evict/GC at map.cpp:13-152). This build's
// host runtime keeps the same data natively too: this is the
// C++ twin of the Python reference implementation / test oracle in
// stereo_visual_slam/mapping/store.py — the same arena layout
// (parallel arrays + free list + dense id->row table), the same distance
// eviction rule (closest-if-<min_dist-else-farthest, map.cpp:48-130), the
// same observation-count GC (clean_map, map.cpp:132-152), and the same
// dense (L, K) window assembly consumed by the device BA schedule.
//
// C ABI throughout, consumed via ctypes (utils/native.py). Handles are
// opaque pointers; all functions return 0/non-negative on success,
// negative on error. Bit-for-bit equivalence with the Python oracle is
// asserted by tests/test_native.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <vector>

#define SIO_API extern "C" __attribute__((visibility("default")))

namespace {

// ||log(T)|| for a rigid transform, matching mapping/store.py se3_log_norm.
double se3_log_norm(const float* T) {
  double R[3][3] = {{T[0], T[1], T[2]},
                    {T[4], T[5], T[6]},
                    {T[8], T[9], T[10]}};
  double t[3] = {T[3], T[7], T[11]};
  double tr = R[0][0] + R[1][1] + R[2][2];
  double cos_t = (tr - 1.0) * 0.5;
  if (cos_t > 1.0) cos_t = 1.0;
  if (cos_t < -1.0) cos_t = -1.0;
  double theta = std::acos(cos_t);
  double a[3] = {R[2][1] - R[1][2], R[0][2] - R[2][0], R[1][0] - R[0][1]};
  double w[3], v[3];
  if (theta < 1e-6) {
    for (int i = 0; i < 3; ++i) {
      w[i] = a[i] * 0.5;
      v[i] = t[i];
    }
  } else {
    double k = theta / (2.0 * std::sin(theta));
    for (int i = 0; i < 3; ++i) w[i] = a[i] * k;
    double wx[3][3] = {{0, -w[2], w[1]}, {w[2], 0, -w[0]}, {-w[1], w[0], 0}};
    double wx2[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        wx2[i][j] = 0;
        for (int k2 = 0; k2 < 3; ++k2) wx2[i][j] += wx[i][k2] * wx[k2][j];
      }
    double t2 = theta * theta;
    double c = (1.0 - theta * std::cos(theta / 2.0) /
                          (2.0 * std::sin(theta / 2.0))) /
               t2;
    double Vinv[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Vinv[i][j] = (i == j ? 1.0 : 0.0) - 0.5 * wx[i][j] + c * wx2[i][j];
    for (int i = 0; i < 3; ++i) {
      v[i] = 0;
      for (int j = 0; j < 3; ++j) v[i] += Vinv[i][j] * t[j];
    }
  }
  double s = 0;
  for (int i = 0; i < 3; ++i) s += v[i] * v[i] + w[i] * w[i];
  return std::sqrt(s);
}

// 4x4 inverse of a rigid transform: [R t]^-1 = [R' -R't].
void invert_rigid(const float* T, float* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[i * 4 + j] = T[j * 4 + i];
  for (int i = 0; i < 3; ++i) {
    double s = 0;
    for (int j = 0; j < 3; ++j) s += out[i * 4 + j] * T[j * 4 + 3];
    out[i * 4 + 3] = static_cast<float>(-s);
  }
  out[12] = out[13] = out[14] = 0.0f;
  out[15] = 1.0f;
}

void matmul4(const float* A, const float* B, float* out) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      double s = 0;
      for (int k = 0; k < 4; ++k) s += A[i * 4 + k] * B[k * 4 + j];
      out[i * 4 + j] = static_cast<float>(s);
    }
}

struct Keyframe {
  int64_t keyframe_id = -1;
  int64_t frame_id = -1;
  float T_c_w[16];
  std::vector<int32_t> rows;  // (n_slots,), -1 where no landmark
  std::vector<float> uv;      // (n_slots, 2)
  std::vector<uint8_t> valid; // (n_slots,)
};

struct MapStore {
  // static config
  int32_t arena_cap;
  int32_t window_size;
  int32_t max_landmarks;  // L of the dense BA window
  int32_t n_slots;        // feature slots per keyframe
  double eviction_min_dist;
  int fix_oldest_pose;

  // landmark arena
  std::vector<float> pos;        // (cap, 3)
  std::vector<uint8_t> reliable; // (cap,)
  std::vector<uint8_t> inlier;   // (cap,)
  std::vector<int32_t> obs_count;
  std::vector<int64_t> row_id;   // arena row -> landmark id (-1 free)
  std::vector<uint8_t> alive;
  std::vector<int32_t> free_list;       // back = next row to hand out
  std::vector<int32_t> id_to_row;       // dense landmark id -> row

  std::map<int64_t, Keyframe> keyframes; // ordered by keyframe id
  int64_t current_keyframe_id = -1;
  std::deque<Keyframe> evicted;
};

MapStore* as_store(void* h) { return static_cast<MapStore*>(h); }

void ensure_id_table(MapStore* m, int64_t max_id) {
  if (max_id >= static_cast<int64_t>(m->id_to_row.size())) {
    size_t grow = ((max_id >> 20) + 1) << 20;  // 1M-entry quanta
    m->id_to_row.resize(grow, -1);
  }
}

void clean_map(MapStore* m) {
  // GC rows with no remaining observations (map.cpp:132-152). Matches the
  // oracle: rows scanned in ascending order, appended to the free list.
  for (int32_t r = 0; r < m->arena_cap; ++r) {
    if (m->alive[r] && m->obs_count[r] <= 0) {
      m->alive[r] = 0;
      if (m->row_id[r] >= 0 &&
          m->row_id[r] < static_cast<int64_t>(m->id_to_row.size()))
        m->id_to_row[m->row_id[r]] = -1;
      m->row_id[r] = -1;
      m->free_list.push_back(r);
    }
  }
}

void remove_keyframe(MapStore* m) {
  // Distance rule of map.cpp:48-130: evict the CLOSEST keyframe to the
  // current one if its distance < min_dist, else the FARTHEST.
  auto cur_it = m->keyframes.find(m->current_keyframe_id);
  if (cur_it == m->keyframes.end()) return;
  float T_w_cur[16];
  invert_rigid(cur_it->second.T_c_w, T_w_cur);
  double min_d = 1e300, max_d = -1e300;
  int64_t min_id = -1, max_id = -1;
  for (auto& [kf_id, kf] : m->keyframes) {
    if (kf_id == m->current_keyframe_id) continue;
    float rel[16];
    matmul4(kf.T_c_w, T_w_cur, rel);
    double d = se3_log_norm(rel);
    if (d < min_d) { min_d = d; min_id = kf_id; }
    if (d > max_d) { max_d = d; max_id = kf_id; }
  }
  if (min_id < 0) return;
  int64_t victim_id = (min_d < m->eviction_min_dist) ? min_id : max_id;
  auto it = m->keyframes.find(victim_id);
  Keyframe victim = std::move(it->second);
  m->keyframes.erase(it);
  for (int i = 0; i < m->n_slots; ++i) {
    int32_t r = victim.rows[i];
    if (victim.valid[i] && r >= 0) m->obs_count[r] -= 1;
  }
  m->evicted.push_back(std::move(victim));
  clean_map(m);
}

}  // namespace

SIO_API void* ms_create(int32_t arena_cap, int32_t window_size,
                        int32_t max_landmarks, int32_t n_slots,
                        double eviction_min_dist, int fix_oldest_pose) {
  auto* m = new MapStore();
  m->arena_cap = arena_cap;
  m->window_size = window_size;
  m->max_landmarks = max_landmarks;
  m->n_slots = n_slots;
  m->eviction_min_dist = eviction_min_dist;
  m->fix_oldest_pose = fix_oldest_pose;
  m->pos.assign(static_cast<size_t>(arena_cap) * 3, 0.0f);
  m->reliable.assign(arena_cap, 0);
  m->inlier.assign(arena_cap, 0);
  m->obs_count.assign(arena_cap, 0);
  m->row_id.assign(arena_cap, -1);
  m->alive.assign(arena_cap, 0);
  m->free_list.resize(arena_cap);
  for (int32_t i = 0; i < arena_cap; ++i)
    m->free_list[i] = arena_cap - 1 - i;  // pop_back yields 0 first
  m->id_to_row.assign(1 << 20, -1);
  return m;
}

SIO_API void ms_destroy(void* h) { delete as_store(h); }

SIO_API int ms_spawn(void* h, int32_t n, const int64_t* ids, const float* pos,
                     const uint8_t* reliable) {
  auto* m = as_store(h);
  if (n > static_cast<int32_t>(m->free_list.size())) return -1;
  int64_t max_id = -1;
  for (int32_t i = 0; i < n; ++i)
    if (ids[i] > max_id) max_id = ids[i];
  ensure_id_table(m, max_id);
  for (int32_t i = 0; i < n; ++i) {
    int32_t r = m->free_list.back();
    m->free_list.pop_back();
    std::memcpy(&m->pos[static_cast<size_t>(r) * 3], pos + i * 3,
                3 * sizeof(float));
    m->reliable[r] = reliable[i];
    m->inlier[r] = 1;
    m->obs_count[r] = 0;
    m->row_id[r] = ids[i];
    m->alive[r] = 1;
    m->id_to_row[ids[i]] = r;
  }
  return 0;
}

SIO_API void ms_rows_of(void* h, int32_t n, const int64_t* ids,
                        int32_t* out) {
  auto* m = as_store(h);
  for (int32_t i = 0; i < n; ++i) {
    int64_t id = ids[i];
    out[i] = (id >= 0 && id < static_cast<int64_t>(m->id_to_row.size()))
                 ? m->id_to_row[id]
                 : -1;
  }
}

SIO_API void ms_upgrade(void* h, int32_t n, const int32_t* rows,
                        const float* pos) {
  auto* m = as_store(h);
  for (int32_t i = 0; i < n; ++i) {
    int32_t r = rows[i];
    if (r < 0 || r >= m->arena_cap) continue;
    std::memcpy(&m->pos[static_cast<size_t>(r) * 3], pos + i * 3,
                3 * sizeof(float));
    m->reliable[r] = 1;
  }
}

SIO_API int ms_insert_keyframe(void* h, int64_t keyframe_id, int64_t frame_id,
                               const float* T_c_w, const int32_t* rows,
                               const float* uv, const uint8_t* valid) {
  auto* m = as_store(h);
  Keyframe kf;
  kf.keyframe_id = keyframe_id;
  kf.frame_id = frame_id;
  std::memcpy(kf.T_c_w, T_c_w, 16 * sizeof(float));
  kf.rows.assign(rows, rows + m->n_slots);
  kf.uv.assign(uv, uv + static_cast<size_t>(m->n_slots) * 2);
  kf.valid.assign(valid, valid + m->n_slots);
  for (int i = 0; i < m->n_slots; ++i)
    if (kf.valid[i] && kf.rows[i] >= 0) m->obs_count[kf.rows[i]] += 1;
  m->keyframes[keyframe_id] = std::move(kf);
  m->current_keyframe_id = keyframe_id;
  if (static_cast<int32_t>(m->keyframes.size()) > m->window_size)
    remove_keyframe(m);
  return 0;
}

SIO_API int32_t ms_n_keyframes(void* h) {
  return static_cast<int32_t>(as_store(h)->keyframes.size());
}

SIO_API int32_t ms_n_landmarks(void* h) {
  auto* m = as_store(h);
  int32_t n = 0;
  for (int32_t r = 0; r < m->arena_cap; ++r) n += m->alive[r];
  return n;
}

SIO_API int32_t ms_evicted_count(void* h) {
  return static_cast<int32_t>(as_store(h)->evicted.size());
}

// Pop the oldest evicted keyframe (for trajectory flushing). Returns 1 when
// one was written to the out params, 0 when the queue is empty.
SIO_API int ms_pop_evicted(void* h, int64_t* keyframe_id, int64_t* frame_id,
                           float* T_c_w) {
  auto* m = as_store(h);
  if (m->evicted.empty()) return 0;
  Keyframe& kf = m->evicted.front();
  *keyframe_id = kf.keyframe_id;
  *frame_id = kf.frame_id;
  std::memcpy(T_c_w, kf.T_c_w, 16 * sizeof(float));
  m->evicted.pop_front();
  return 1;
}

// Dense (L, K) BA window assembly; mirrors
// MapStore.assemble_schedule_input. Returns the number of active keyframes
// (0 => nothing to optimize). Out buffers sized by the caller:
//   T (Kw*16), uv (L*Kw*2), obs (L*Kw), pose_mask (Kw), fixed (Kw),
//   pts (L*3), inlier (L), reliable (L), present (L),
//   kf_ids (Kw i64), sel_rows (L i32, -1 padded).
SIO_API int32_t ms_assemble(void* h, float* T, float* uv, float* obs,
                            float* pose_mask, float* fixed, float* pts,
                            float* inlier, float* reliable, float* present,
                            int64_t* kf_ids, int32_t* sel_rows) {
  auto* m = as_store(h);
  const int32_t Kw = m->window_size;
  const int32_t L = m->max_landmarks;
  const int32_t nK = static_cast<int32_t>(m->keyframes.size());
  if (nK == 0) return 0;

  // union of observed rows, ascending (np.unique semantics)
  std::vector<uint8_t> seen(m->arena_cap, 0);
  for (auto& [kf_id, kf] : m->keyframes)
    for (int i = 0; i < m->n_slots; ++i)
      if (kf.valid[i] && kf.rows[i] >= 0) seen[kf.rows[i]] = 1;
  std::vector<int32_t> sel;
  sel.reserve(L);
  for (int32_t r = 0; r < m->arena_cap; ++r)
    if (seen[r]) {
      sel.push_back(r);
      if (static_cast<int32_t>(sel.size()) == L) break;
    }
  const int32_t nL = static_cast<int32_t>(sel.size());
  if (nL == 0) return 0;

  // zero/identity-init outputs
  for (int k = 0; k < Kw; ++k) {
    std::memset(T + k * 16, 0, 16 * sizeof(float));
    T[k * 16 + 0] = T[k * 16 + 5] = T[k * 16 + 10] = T[k * 16 + 15] = 1.0f;
    pose_mask[k] = 0.0f;
    fixed[k] = 0.0f;
    kf_ids[k] = -1;
  }
  std::memset(uv, 0, static_cast<size_t>(L) * Kw * 2 * sizeof(float));
  std::memset(obs, 0, static_cast<size_t>(L) * Kw * sizeof(float));
  std::memset(pts, 0, static_cast<size_t>(L) * 3 * sizeof(float));
  std::memset(inlier, 0, static_cast<size_t>(L) * sizeof(float));
  std::memset(reliable, 0, static_cast<size_t>(L) * sizeof(float));
  std::memset(present, 0, static_cast<size_t>(L) * sizeof(float));
  for (int32_t i = 0; i < L; ++i) sel_rows[i] = -1;

  std::vector<int32_t> row_to_idx(m->arena_cap, -1);
  for (int32_t i = 0; i < nL; ++i) {
    int32_t r = sel[i];
    sel_rows[i] = r;
    row_to_idx[r] = i;
    std::memcpy(pts + i * 3, &m->pos[static_cast<size_t>(r) * 3],
                3 * sizeof(float));
    inlier[i] = m->inlier[r] ? 1.0f : 0.0f;
    reliable[i] = m->reliable[r] ? 1.0f : 0.0f;
    present[i] = 1.0f;
  }

  int k = 0;
  for (auto& [kf_id, kf] : m->keyframes) {  // std::map: ascending kf id
    std::memcpy(T + k * 16, kf.T_c_w, 16 * sizeof(float));
    pose_mask[k] = 1.0f;
    kf_ids[k] = kf_id;
    for (int i = 0; i < m->n_slots; ++i) {
      if (!kf.valid[i] || kf.rows[i] < 0) continue;
      int32_t idx = row_to_idx[kf.rows[i]];
      if (idx < 0) continue;
      uv[(static_cast<size_t>(idx) * Kw + k) * 2 + 0] = kf.uv[i * 2 + 0];
      uv[(static_cast<size_t>(idx) * Kw + k) * 2 + 1] = kf.uv[i * 2 + 1];
      obs[static_cast<size_t>(idx) * Kw + k] = 1.0f;
    }
    ++k;
  }
  if (m->fix_oldest_pose) fixed[0] = 1.0f;
  return nK;
}

SIO_API void ms_write_back(void* h, int32_t nK, const int64_t* kf_ids,
                           const float* T_c_w, int32_t nR,
                           const int32_t* rows, const float* inlier) {
  auto* m = as_store(h);
  for (int32_t i = 0; i < nK; ++i) {
    auto it = m->keyframes.find(kf_ids[i]);
    if (it != m->keyframes.end())
      std::memcpy(it->second.T_c_w, T_c_w + i * 16, 16 * sizeof(float));
  }
  for (int32_t i = 0; i < nR; ++i) {
    int32_t r = rows[i];
    if (r >= 0 && r < m->arena_cap && m->alive[r])
      m->inlier[r] = inlier[i] > 0.5f ? 1 : 0;
  }
}

// Bulk state readout for oracle-equivalence tests.
SIO_API void ms_arena_state(void* h, float* pos, uint8_t* reliable,
                            uint8_t* inlier, int32_t* obs_count,
                            int64_t* row_id, uint8_t* alive) {
  auto* m = as_store(h);
  std::memcpy(pos, m->pos.data(), m->pos.size() * sizeof(float));
  std::memcpy(reliable, m->reliable.data(), m->reliable.size());
  std::memcpy(inlier, m->inlier.data(), m->inlier.size());
  std::memcpy(obs_count, m->obs_count.data(),
              m->obs_count.size() * sizeof(int32_t));
  std::memcpy(row_id, m->row_id.data(), m->row_id.size() * sizeof(int64_t));
  std::memcpy(alive, m->alive.data(), m->alive.size());
}
