// K2: one NeuS up-sampling round of the importance sampler, per ray.
//
// Replaces the per-ray logic of the TPU kernel
// ops/pallas_sampler.py:fused_importance_sampler (_up_weights,
// _sample_pdf and _merge_sorted inside _sampler_kernel_lanes /
// _sampler_kernel); K1 (sdf_mlp.cu) takes the kernel's MLP body.
//
// What it computes, for one ray: the stable merge of two sorted sample
// sets (a before b on ties) with their sdf payload; the section weights
// of the NeuS round at inv_s (cosine clamped to the minimum of itself and
// its predecessor, clipped to [-1e3, 0], masked to the unit sphere;
// sigmoid-CDF alpha; transmittance as a running product); and the
// deterministic inverse-CDF draw at u = (j + 0.5) / n_draw. On the last
// round it merges the draws in and writes the final sorted z.
//
// What bounds it: a ray holds at most 32 + 16 values and does a few
// hundred dependent flops and compares on them; the (R, <=32) rows in and
// out are a few MB. Latency of that sequential chain bounds it, not
// bytes or the FMA rate.
//
// The design: one thread per ray, the row in registers and local memory,
// with data-dependent indices (the TPU version spent O(n^2) one-hot
// compares because Mosaic has no gather; here a two-pointer merge and a
// linear CDF scan do the same work in O(n)).
#include <cuda_runtime.h>

namespace {

constexpr int MAXN = 64;  // widest row: merged samples plus draws

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// stable merge of sorted a (na) and b (nb) into z, with payloads
__device__ __forceinline__ void merge(const float* za, const float* sa, int na,
                                      const float* zb, const float* sb, int nb,
                                      float* z, float* s) {
  int i = 0, j = 0;
  for (int k = 0; k < na + nb; ++k) {
    const bool take_a = j >= nb || (i < na && za[i] <= zb[j]);
    if (take_a) { z[k] = za[i]; if (s) s[k] = sa[i]; ++i; }
    else        { z[k] = zb[j]; if (s) s[k] = sb[j]; ++j; }
  }
}

__global__ void up_sample_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                                 const float* __restrict__ za, const float* __restrict__ sa, int na,
                                 const float* __restrict__ zb, const float* __restrict__ sb, int nb,
                                 int n_draw, float inv_s, int last, long long n_rays,
                                 float* __restrict__ out_z, float* __restrict__ out_sdf,
                                 float* __restrict__ out_new) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float o0 = rays_o[r * 3], o1 = rays_o[r * 3 + 1], o2 = rays_o[r * 3 + 2];
  const float d0 = rays_d[r * 3], d1 = rays_d[r * 3 + 1], d2 = rays_d[r * 3 + 2];

  const int n = na + nb;
  float z[MAXN], s[MAXN];
  merge(za + r * na, sa + r * na, na, zb + r * nb, sb + r * nb, nb, z, s);

  // section weights; cdf[0] = 0, cdf[k + 1] = cdf[k] + pdf[k]
  auto radius = [&](float t) {
    const float px = o0 + d0 * t, py = o1 + d1 * t, pz = o2 + d2 * t;
    return sqrtf(px * px + py * py + pz * pz);
  };
  float w[MAXN];
  float trans = 1.0f, prev_cos = 0.0f, wsum = 0.0f, rad = radius(z[0]);
  for (int k = 0; k < n - 1; ++k) {
    const float rad_next = radius(z[k + 1]);
    const bool inside = rad < 1.0f || rad_next < 1.0f;
    rad = rad_next;
    const float mid = (s[k] + s[k + 1]) * 0.5f;
    const float cos_raw = (s[k + 1] - s[k]) / (z[k + 1] - z[k] + 1e-5f);
    float c = fminf(prev_cos, cos_raw);
    prev_cos = cos_raw;
    c = inside ? fminf(fmaxf(c, -1e3f), 0.0f) : 0.0f;
    const float dist = z[k + 1] - z[k];
    const float prev_cdf = sigmoid((mid - c * dist * 0.5f) * inv_s);
    const float next_cdf = sigmoid((mid + c * dist * 0.5f) * inv_s);
    const float alpha = (prev_cdf - next_cdf + 1e-5f) / (prev_cdf + 1e-5f);
    w[k] = alpha * trans + 1e-5f;
    trans *= 1.0f - alpha + 1e-7f;
    wsum += w[k];
  }
  float cdf[MAXN];
  cdf[0] = 0.0f;
  for (int k = 0; k < n - 1; ++k) cdf[k + 1] = cdf[k] + w[k] / wsum;

  float nz[MAXN];
  for (int j = 0; j < n_draw; ++j) {
    const float u = (j + 0.5f) / n_draw;
    int inds = 0;
    for (int k = 0; k < n; ++k) inds += cdf[k] <= u;
    const int below = max(inds - 1, 0), above = min(inds, n - 1);
    const float c_lo = cdf[below], c_hi = cdf[above];
    float denom = c_hi - c_lo;
    denom = denom < 1e-5f ? 1.0f : denom;
    const float t = (u - c_lo) / denom;
    nz[j] = z[below] + t * (z[above] - z[below]);
  }

  if (last) {
    float zo[MAXN];
    merge(z, nullptr, n, nz, nullptr, n_draw, zo, nullptr);
    for (int k = 0; k < n + n_draw; ++k) out_z[r * (n + n_draw) + k] = zo[k];
  } else {
    for (int k = 0; k < n; ++k) { out_z[r * n + k] = z[k]; out_sdf[r * n + k] = s[k]; }
    for (int j = 0; j < n_draw; ++j) out_new[r * n_draw + j] = nz[j];
  }
}

}  // namespace

// Returns a cudaError_t value (0 = launched), or -1 for rows wider than
// the kernel holds. zb / sb may be null with nb == 0. On the last round
// out_z is (R, na + nb + n_draw) and out_sdf / out_new are unused;
// otherwise out_z, out_sdf are (R, na + nb) and out_new is (R, n_draw).
extern "C" int nw_up_sample(const float* rays_o, const float* rays_d, const float* za,
                            const float* sa, int na, const float* zb, const float* sb, int nb,
                            int n_draw, float inv_s, int last, long long n_rays, float* out_z,
                            float* out_sdf, float* out_new, void* stream) {
  if (na < 1 || nb < 0 || n_draw < 1 || na + nb + n_draw > MAXN) return -1;
  if (n_rays <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n_rays + threads - 1) / threads;
  up_sample_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays_o, rays_d, za, sa, na, zb, sb, nb, n_draw, inv_s, last, n_rays, out_z, out_sdf,
      out_new);
  return (int)cudaGetLastError();
}
