// Native host-side planning core.
//
// C++ equivalents of the hot host-side planning loops (the TPU is busy
// rendering candidate views while these run; the reference spends this
// time in pure Python):
//   * dijkstra_plan    — 8-connected grid Dijkstra with a binary heap
//                        (reference: planning/dijkstra.py:17-260, O(V^2))
//   * raycast_update   — Bresenham scan fusion into the cost map
//                        (reference: perception/data_proc/depth_to_grid.py:142-197)
//   * voxel_traverse   — Amanatides-Woo 3D DDA between two voxels
//                        (reference: planning/planning_funcs.py:97-159)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this
// image). All grids are row-major contiguous.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <queue>
#include <vector>
#include <limits>

extern "C" {

// --------------------------------------------------------------------
// Dijkstra on an X x Y obstacle grid (nonzero = blocked).
// Returns path length (#cells) or 0 if unreachable; path written
// goal->start into out_x/out_y (capacity max_path).
// --------------------------------------------------------------------
int32_t dijkstra_plan(
    const uint8_t* obstacle, int32_t X, int32_t Y,
    int32_t sx, int32_t sy, int32_t gx, int32_t gy,
    int32_t* out_x, int32_t* out_y, int32_t max_path) {
  if (sx < 0 || sy < 0 || sx >= X || sy >= Y) return 0;
  if (gx < 0 || gy < 0 || gx >= X || gy >= Y) return 0;

  const int32_t n = X * Y;
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> dist(n, INF);
  std::vector<int32_t> parent(n, -1);
  std::vector<uint8_t> done(n, 0);

  static const int dxs[8] = {1, 0, -1, 0, -1, -1, 1, 1};
  static const int dys[8] = {0, 1, 0, -1, -1, 1, -1, 1};
  const double SQRT2 = std::sqrt(2.0);

  using QE = std::pair<double, int32_t>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;
  const int32_t s = sx * Y + sy, g = gx * Y + gy;
  dist[s] = 0.0;
  heap.push({0.0, s});

  while (!heap.empty()) {
    auto [d, node] = heap.top();
    heap.pop();
    if (done[node]) continue;
    done[node] = 1;
    if (node == g) break;
    const int32_t cx = node / Y, cy = node % Y;
    for (int k = 0; k < 8; ++k) {
      const int32_t nx = cx + dxs[k], ny = cy + dys[k];
      if (nx < 0 || ny < 0 || nx >= X || ny >= Y) continue;
      const int32_t nn = nx * Y + ny;
      if (done[nn] || obstacle[nn]) continue;
      const double nd = d + (k < 4 ? 1.0 : SQRT2);
      if (nd < dist[nn]) {
        dist[nn] = nd;
        parent[nn] = node;
        heap.push({nd, nn});
      }
    }
  }
  if (!done[g]) return 0;

  int32_t count = 0;
  for (int32_t node = g; node != -1 && count < max_path;
       node = parent[node]) {
    out_x[count] = node / Y;
    out_y[count] = node % Y;
    ++count;
  }
  return count;
}

// --------------------------------------------------------------------
// Bresenham beam free-space carving + endpoint occupancy marking.
// occupancy: X x Y doubles (0.5 unknown / 0 free / 1 occupied).
// One beam per (ox, oy) world endpoint from grid cell (loc_x, loc_y).
// --------------------------------------------------------------------
static inline void bresenham_mark(
    double* occ, int32_t X, int32_t Y,
    int32_t x1, int32_t y1, int32_t x2, int32_t y2) {
  int32_t dx = std::abs(x2 - x1), dy = std::abs(y2 - y1);
  int32_t sx = x1 < x2 ? 1 : -1, sy = y1 < y2 ? 1 : -1;
  int32_t err = dx - dy;
  int32_t x = x1, y = y1;
  while (true) {
    if (x >= 0 && y >= 0 && x < X && y < Y) occ[x * Y + y] = 0.0;
    if (x == x2 && y == y2) break;
    const int32_t e2 = 2 * err;
    if (e2 > -dy) { err -= dy; x += sx; }
    if (e2 < dx)  { err += dx; y += sy; }
  }
}

void raycast_update(
    double* occupancy, int32_t X, int32_t Y,
    const double* ox, const double* oy, int32_t n_beams,
    int32_t loc_x, int32_t loc_y,
    double min_x, double min_y, double resolution) {
  for (int32_t i = 0; i < n_beams; ++i) {
    const int32_t ix = (int32_t)std::lround((ox[i] - min_x) / resolution);
    const int32_t iy = (int32_t)std::lround((oy[i] - min_y) / resolution);
    bresenham_mark(occupancy, X, Y, loc_x, loc_y, ix, iy);
    for (int dx = 0; dx <= 1; ++dx)
      for (int dy = 0; dy <= 1; ++dy) {
        const int32_t px = ix + dx, py = iy + dy;
        if (px >= 0 && py >= 0 && px < X && py < Y)
          occupancy[px * Y + py] = 1.0;
      }
  }
}

// --------------------------------------------------------------------
// Amanatides-Woo 3D DDA: voxels crossed from start voxel toward end
// voxel. Returns count; voxels written as (x, y, z) triples.
// --------------------------------------------------------------------
int32_t voxel_traverse(
    const double* start_pos, const double* end_pos,
    const int32_t* start_voxel, const int32_t* end_voxel,
    double voxel_size, int32_t* out_xyz, int32_t max_voxels) {
  double ray[3], t_max[3], t_delta[3];
  int32_t cur[3], step[3];
  const double INF = std::numeric_limits<double>::infinity();
  for (int i = 0; i < 3; ++i) {
    cur[i] = start_voxel[i];
    ray[i] = end_pos[i] - start_pos[i];
    step[i] = ray[i] >= 0 ? 1 : -1;
    const double next_boundary = (cur[i] + step[i]) * voxel_size;
    t_max[i] = ray[i] != 0 ? (next_boundary - start_pos[i]) / ray[i] : INF;
    t_delta[i] = ray[i] != 0 ? voxel_size / ray[i] * step[i] : INF;
  }
  double range_sq = 0, dist = 0;
  for (int i = 0; i < 3; ++i) {
    const double d = (end_voxel[i] - start_voxel[i]) * voxel_size;
    range_sq += d * d;
  }
  int32_t count = 0;
  while (dist <= range_sq && count < max_voxels) {
    int axis = 0;
    if (t_max[1] < t_max[0]) axis = 1;
    if (t_max[2] < t_max[axis]) axis = 2;
    cur[axis] += step[axis];
    t_max[axis] += t_delta[axis];
    out_xyz[count * 3 + 0] = cur[0];
    out_xyz[count * 3 + 1] = cur[1];
    out_xyz[count * 3 + 2] = cur[2];
    ++count;
    dist = 0;
    for (int i = 0; i < 3; ++i) {
      const double d = (cur[i] - start_voxel[i]) * voxel_size;
      dist += d * d;
    }
  }
  return count;
}

}  // extern "C"
