// Native host-side input-pipeline kernels (C++, ctypes ABI).
//
// The data loader's hot ops run on the host while the GPU computes; the
// numpy resample allocates 8 full-volume temporaries per trilinear sample
// (augment.rotate_and_scale on a 160^3 x 4 scene touches ~1.6 GB of
// temporaries).  These C++ kernels stream the work voxel-by-voxel with zero
// allocations, and are loaded through ctypes (nerf_rpn_tpu_torch/native).
//
// Copy of nerf_rpn_tpu/native/augment.cpp: the same code, built with the
// same flags.  Semantics mirror the numpy twin
// nerf_rpn_tpu_torch/data/augment.py::rotate_scale_resample_plain
// (align_corners grid_sample convention, zero padding outside) --
// parity-tested in tests/test_torch_native.py.

#include <cmath>
#include <cstdint>
#include <algorithm>

extern "C" {

// Trilinear resample of a (W, L, H, C) volume onto a grid rotated by
// `angle` about +z and scaled by `scale` (the reference's
// rotate_and_scale_scene sampling, datasets.py:291-329).
void rotate_scale_resample(const float* src, int W, int L, int H, int C,
                           float angle, float scale, float* dst) {
  const float ca = std::cos(angle) * scale;
  const float sa = std::sin(angle) * scale;
  const int dims[3] = {W, L, H};
  // linspace(-1, 1, n) * n / 2  ->  start = -n/2, step = n/(n-1)
  float start[3], step[3];
  for (int a = 0; a < 3; ++a) {
    start[a] = -dims[a] / 2.0f;
    step[a] = dims[a] > 1 ? dims[a] / float(dims[a] - 1) : 0.0f;
  }
  const int64_t sL = (int64_t)H * C;
  const int64_t sW = (int64_t)L * sL;

  int64_t out = 0;
  for (int i = 0; i < W; ++i) {
    const float px = start[0] + step[0] * i;
    for (int j = 0; j < L; ++j) {
      const float py = start[1] + step[1] * j;
      // rotate (px, py) about z, z passes through scaled only
      const float gx = ca * px - sa * py;
      const float gy = sa * px + ca * py;
      // centred coords -> voxel coords (align_corners)
      const float vx = (gx / (dims[0] / 2.0f) + 1.0f) * 0.5f * (dims[0] - 1);
      const float vy = (gy / (dims[1] / 2.0f) + 1.0f) * 0.5f * (dims[1] - 1);
      for (int k = 0; k < H; ++k, out += C) {
        const float pz = (start[2] + step[2] * k) * scale;
        const float vz = (pz / (dims[2] / 2.0f) + 1.0f) * 0.5f * (dims[2] - 1);

        const int x0 = (int)std::floor(vx), y0 = (int)std::floor(vy),
                  z0 = (int)std::floor(vz);
        const float fx = vx - x0, fy = vy - y0, fz = vz - z0;
        for (int c = 0; c < C; ++c) dst[out + c] = 0.0f;
        for (int dx = 0; dx <= 1; ++dx) {
          const int xi = x0 + dx;
          if (xi < 0 || xi >= W) continue;
          const float wx = dx ? fx : 1.0f - fx;
          for (int dy = 0; dy <= 1; ++dy) {
            const int yi = y0 + dy;
            if (yi < 0 || yi >= L) continue;
            const float wy = dy ? fy : 1.0f - fy;
            for (int dz = 0; dz <= 1; ++dz) {
              const int zi = z0 + dz;
              if (zi < 0 || zi >= H) continue;
              const float w = wx * wy * (dz ? fz : 1.0f - fz);
              const float* s = src + (int64_t)xi * sW + (int64_t)yi * sL +
                               (int64_t)zi * C;
              for (int c = 0; c < C; ++c) dst[out + c] += w * s[c];
            }
          }
        }
      }
    }
  }
}

// instant-ngp density -> alpha: clip(1 - exp(-exp(sigma) / 100), 0, 1)
// applied in place to the last channel of a (N, C) row-major buffer.
void density_to_alpha_ngp(float* rgbsigma, int64_t n, int c) {
  for (int64_t i = 0; i < n; ++i) {
    float s = rgbsigma[i * c + c - 1];
    float a = 1.0f - std::exp(-std::exp(s) / 100.0f);
    rgbsigma[i * c + c - 1] = std::min(1.0f, std::max(0.0f, a));
  }
}

// ReLU-activation variant (ScanNet / dense-depth-priors NeRF).
void density_to_alpha_relu(float* rgbsigma, int64_t n, int c) {
  for (int64_t i = 0; i < n; ++i) {
    float s = std::max(0.0f, rgbsigma[i * c + c - 1]);
    float a = 1.0f - std::exp(-s / 100.0f);
    rgbsigma[i * c + c - 1] = std::min(1.0f, std::max(0.0f, a));
  }
}

// uint8 (N,) -> float32 [0, 1]
void u8_to_unit_float(const uint8_t* src, int64_t n, float* dst) {
  constexpr float inv = 1.0f / 255.0f;
  for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * inv;
}

}  // extern "C"
