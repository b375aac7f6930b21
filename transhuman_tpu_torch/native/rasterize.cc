// Z-buffer triangle-mesh rasterizer with normal-map shading, C++ backend.
//
// The counterpart of the reference's offline PyTorch3D mesh-video renderer
// (render_mesh_dynamic.py:113-353): renders an exported .ply along the
// spherical camera path with per-face-normal coloring.  CPU z-buffer
// rasterization — meshes are ~100k faces at 512x512, well within host
// budget — so the card stays free for the neural pipelines.
//
// A copy of the JAX package's transhuman_tpu/native/rasterize.cc.  Built by
// native/build.py (g++ -O3 -std=c++17 -shared -fPIC, no -march) into
// _build/librasterize.so; loaded via ctypes (viz/mesh_render.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// verts: (nv,3) world; tris: (nt,3); K: 3x3 row-major; R: 3x3 world->cam;
// T: (3,). out_rgb: H*W*3 (normal-mapped color, bg 0); out_depth: H*W
// (+inf where empty -> written as 0).
int rz_render(const float* verts, int64_t nv, const int64_t* tris, int64_t nt,
              const float* K, const float* R, const float* T, int64_t H,
              int64_t W, float* out_rgb, float* out_depth) {
  std::vector<float> cam(nv * 3);
  for (int64_t i = 0; i < nv; ++i) {
    const float* p = verts + i * 3;
    for (int r = 0; r < 3; ++r)
      cam[i * 3 + r] =
          R[r * 3 + 0] * p[0] + R[r * 3 + 1] * p[1] + R[r * 3 + 2] * p[2] + T[r];
  }
  std::vector<float> uvz(nv * 3);
  for (int64_t i = 0; i < nv; ++i) {
    float x = cam[i * 3], y = cam[i * 3 + 1], z = cam[i * 3 + 2];
    float px = K[0] * x + K[1] * y + K[2] * z;
    float py = K[3] * x + K[4] * y + K[5] * z;
    float pz = K[6] * x + K[7] * y + K[8] * z;
    float zz = (std::fabs(pz) < 1e-8f) ? 1e-8f : pz;
    uvz[i * 3] = px / zz;
    uvz[i * 3 + 1] = py / zz;
    uvz[i * 3 + 2] = z;
  }

  std::vector<float> zbuf(H * W, 1e30f);
  std::fill(out_rgb, out_rgb + H * W * 3, 0.f);

  for (int64_t t = 0; t < nt; ++t) {
    int64_t a = tris[t * 3], b = tris[t * 3 + 1], c = tris[t * 3 + 2];
    float za = uvz[a * 3 + 2], zb = uvz[b * 3 + 2], zc = uvz[c * 3 + 2];
    if (za <= 1e-6f || zb <= 1e-6f || zc <= 1e-6f) continue;  // behind camera
    float ax = uvz[a * 3], ay = uvz[a * 3 + 1];
    float bx = uvz[b * 3], by = uvz[b * 3 + 1];
    float cx = uvz[c * 3], cy = uvz[c * 3 + 1];
    float minx = std::floor(std::min({ax, bx, cx}));
    float maxx = std::ceil(std::max({ax, bx, cx}));
    float miny = std::floor(std::min({ay, by, cy}));
    float maxy = std::ceil(std::max({ay, by, cy}));
    int64_t x0 = std::max<int64_t>(0, (int64_t)minx);
    int64_t x1 = std::min<int64_t>(W - 1, (int64_t)maxx);
    int64_t y0 = std::max<int64_t>(0, (int64_t)miny);
    int64_t y1 = std::min<int64_t>(H - 1, (int64_t)maxy);
    if (x0 > x1 || y0 > y1) continue;

    float den = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay);
    if (std::fabs(den) < 1e-12f) continue;

    // world-space face normal -> color (n * 0.5 + 0.5)
    const float* pa = verts + a * 3;
    const float* pb = verts + b * 3;
    const float* pc = verts + c * 3;
    float e1[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
    float e2[3] = {pc[0] - pa[0], pc[1] - pa[1], pc[2] - pa[2]};
    float n[3] = {e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                  e1[0] * e2[1] - e1[1] * e2[0]};
    float nl = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (nl < 1e-12f) continue;
    // orient toward the camera (view dir = cam-space z through R)
    float view_dot = n[0] * R[6] + n[1] * R[7] + n[2] * R[8];
    float flip = view_dot > 0 ? -1.f : 1.f;
    float col[3] = {flip * n[0] / nl * 0.5f + 0.5f,
                    flip * n[1] / nl * 0.5f + 0.5f,
                    flip * n[2] / nl * 0.5f + 0.5f};

    float iza = 1.f / za, izb = 1.f / zb, izc = 1.f / zc;
    // coverage sampled at INTEGER (x, y): this codebase's convention puts
    // pixel centers at integer coordinates (OpenCV projection; the ray
    // generator and grid_sample(align_corners=True) sampling both treat
    // integer coords as sample points), so integer-coord tests ARE
    // pixel-center tests — do not add a +0.5 "center" offset here
    for (int64_t y = y0; y <= y1; ++y) {
      for (int64_t x = x0; x <= x1; ++x) {
        float w1 = ((bx - (float)x) * (cy - (float)y) -
                    (cx - (float)x) * (by - (float)y)) / den;
        float w2 = ((cx - (float)x) * (ay - (float)y) -
                    (ax - (float)x) * (cy - (float)y)) / den;
        float w3 = 1.f - w1 - w2;
        if (w1 < 0 || w2 < 0 || w3 < 0) continue;
        float iz = w1 * iza + w2 * izb + w3 * izc;
        float z = 1.f / iz;
        float* zb_px = &zbuf[y * W + x];
        if (z < *zb_px) {
          *zb_px = z;
          float* px = out_rgb + (y * W + x) * 3;
          px[0] = col[0];
          px[1] = col[1];
          px[2] = col[2];
        }
      }
    }
  }
  for (int64_t i = 0; i < H * W; ++i)
    out_depth[i] = zbuf[i] >= 1e29f ? 0.f : zbuf[i];
  return 0;
}

}  // extern "C"
