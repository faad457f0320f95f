// Native scenario generator: batched slippery-patch terrain rasterizer +
// disturbance schedules (the data-loader / world-builder role that Gazebo's
// C++ world plugins and model SDFs fill in the reference).
//
// Rasterizes N random worlds of circle/box friction patches into mu grids
// and samples randomized push schedules, writing straight into caller-
// provided buffers (zero-copy into numpy via ctypes).  Python fallback:
// apf_quadruped/sim/terrain.py::random_patches.
//
// Build: cc -O2 -shared -fPIC -o libscenariogen.so scenario_gen.cpp
// (driven by native/build.sh / the ctypes loader in
//  apf_quadruped/runtime/native.py)

#include <cstdint>
#include <cmath>
#include <cstring>

namespace {

// xorshift128+ — deterministic, seedable, fast; one stream per scenario so
// generation order is independent of threading.
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    // splitmix64 init
    uint64_t z = seed + 0x9e3779b97f4a7c15ull;
    auto mix = [](uint64_t& z) {
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
      return z ^ (z >> 31);
    };
    s0 = mix(z);
    z += 0x9e3779b97f4a7c15ull;
    s1 = mix(z);
    if (!s0 && !s1) s0 = 1;
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  double uniform() {  // [0, 1)
    return (next() >> 11) * (1.0 / 9007199254740992.0);
  }
  double uniform(double lo, double hi) { return lo + (hi - lo) * uniform(); }
};

}  // namespace

extern "C" {

// Rasterize `batch` random patch worlds into mu_out (batch x res x res,
// float32, row-major; grid spans [-extent, extent]^2, cell centers).
// Patches: n_patches per world, circle or box with equal probability,
// mu in [mu_lo, mu_hi], centers x in [-area/2, area/2], y in [0.6, area]
// (mirroring the reference case worlds: obstacles straddle the forward
// path).  Returns 0 on success.
int generate_terrains(float* mu_out, int batch, int res, float extent,
                      float mu_default, int n_patches, float mu_lo,
                      float mu_hi, float area, uint64_t seed) {
  if (!mu_out || batch <= 0 || res <= 0) return 1;
  const double cell = 2.0 * extent / res;
  for (int b = 0; b < batch; ++b) {
    Rng rng(seed * 0x51f15eedull + (uint64_t)b * 0x9e3779b9ull + 1);
    float* grid = mu_out + (size_t)b * res * res;
    for (int i = 0; i < res * res; ++i) grid[i] = mu_default;
    for (int p = 0; p < n_patches; ++p) {
      double cx = rng.uniform(-area / 2, area / 2);
      double cy = rng.uniform(0.6, area);
      double mu = rng.uniform(mu_lo, mu_hi);
      bool circle = rng.uniform() < 0.5;
      double r = rng.uniform(0.2, 0.5);
      double lx = rng.uniform(0.3, 0.8), ly = rng.uniform(0.3, 0.8);
      for (int iy = 0; iy < res; ++iy) {
        double y = -extent + (iy + 0.5) * cell;
        for (int ix = 0; ix < res; ++ix) {
          double x = -extent + (ix + 0.5) * cell;
          bool inside =
              circle ? ((x - cx) * (x - cx) + (y - cy) * (y - cy) <= r * r)
                     : (std::fabs(x - cx) <= lx / 2 &&
                        std::fabs(y - cy) <= ly / 2);
          if (inside) grid[iy * res + ix] = (float)mu;
        }
      }
    }
  }
  return 0;
}

// Randomized push schedules (batch x n_events x 7 float32 rows of
// [t0, t1, fx, fy, fz, 0, 0]), like the reference force_plugin's random
// case block (force_plugin.cpp:200-326).
int generate_disturbances(float* out, int batch, int n_events,
                          float horizon_s, float f_max, float dur,
                          uint64_t seed) {
  if (!out || batch <= 0 || n_events <= 0) return 1;
  for (int b = 0; b < batch; ++b) {
    Rng rng(seed * 0xc2b2ae3d5ull + (uint64_t)b * 0x165667b1ull + 7);
    for (int e = 0; e < n_events; ++e) {
      float* row = out + ((size_t)b * n_events + e) * 7;
      double t0 = rng.uniform(0.5, horizon_s - dur);
      row[0] = (float)t0;
      row[1] = (float)(t0 + dur);
      row[2] = (float)rng.uniform(-f_max, f_max);
      row[3] = (float)rng.uniform(-f_max, f_max);
      row[4] = 0.0f;
      row[5] = 0.0f;
      row[6] = 0.0f;
    }
  }
  return 0;
}

// Navigation targets (batch x 2): x in [-0.6, 0.6], y in [1.2, 2.2].
int generate_targets(float* out, int batch, uint64_t seed) {
  if (!out || batch <= 0) return 1;
  for (int b = 0; b < batch; ++b) {
    Rng rng(seed * 0x2545f491ull + (uint64_t)b * 0x85ebca6bull + 3);
    out[b * 2 + 0] = (float)rng.uniform(-0.6, 0.6);
    out[b * 2 + 1] = (float)rng.uniform(1.2, 2.2);
  }
  return 0;
}

}  // extern "C"
