// K2: one NeuS up-sampling round of the importance sampler, one warp per ray.
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
// What bounds it on this card: not bytes (the (R, n) rows in and out are
// a few MB, under a microsecond at 3.35 TB/s) and not the FMA rate, but
// the latency of short dependent chains along the row (the transmittance
// product, the CDF sum, the draws' search) and, at the shipped widths
// (rows of at most 24), the launch itself.
//
// The design: one warp per ray, RAYS_PER_BLOCK rays a block, so 8192 rays
// are 2,048 blocks over the 132 SMs. A row of n <= 32 V samples lives in
// registers, lane k holding samples k V .. k V + V - 1 (V a template
// parameter: 1 for the shipped widths, up to 32 for rows of 1024).
//  - Rows load and store coalesced through the warp's shared-memory
//    slice (index e at e + e / 32, so that lane k reading k V + v hits
//    distinct banks).
//  - Merges by rank, not by two pointers: a_i lands at i + #{b < a_i},
//    b_j at j + #{a <= b_j} (a before b on ties, as merge_sorted), each
//    count a binary search of the other row in the slice. The first
//    merge scatters the values and their sdf to the slice at that rank
//    and reads them back by lane; the last round's merge of the draws
//    writes each value at its rank in the output row (the slice's round
//    trip cost 3 % more there).
//  - Section k's right end and the cosine's predecessor come from the
//    neighbouring lane by __shfl_down_sync / __shfl_up_sync.
//  - The chains are warp scans: each lane runs its V values serially, the
//    warp scans the lane totals in 5 shuffle steps (the transmittance an
//    exclusive product, the CDF an inclusive sum; the weights' sum a
//    butterfly).
//  - Draws: at V = 1, the count of CDF values <= u_j is the popcount of a
//    ballot and lane j fetches the CDF and z at both ends of its bin by
//    __shfl_sync; wider rows search the CDF in the slice.
// Nothing is indexed at run time in registers, so V = 1 keeps no
// local-memory frame (the build's -Xptxas -v shows it).
#include <cuda_runtime.h>

namespace {

constexpr int MAX_WIDTH = 1024;    // widest row: merged samples plus draws
constexpr int RAYS_PER_BLOCK = 4;  // one warp each
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// slot of row index e in a warp's slice: one pad word per 32
__device__ __forceinline__ int at(int e) { return e + (e >> 5); }

// #{k < len : row[k] < x} and #{k < len : row[k] <= x} of a sorted row
// that starts at index off of a slice
__device__ __forceinline__ int count_below(const float* slice, int off, int len, float x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (slice[at(off + mid)] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_at_or_below(const float* slice, int off, int len, float x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (slice[at(off + mid)] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float warp_scan_prod(float x, int lane) {  // inclusive
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float t = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x *= t;
  }
  return x;
}

__device__ __forceinline__ float warp_scan_sum(float x, int lane) {  // inclusive
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float t = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += t;
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {  // every lane gets the same sum
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(FULL, x, m);
  return x;
}

template <int V>
__global__ void __launch_bounds__(RAYS_PER_BLOCK * 32)
up_sample_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                 const float* __restrict__ za, const float* __restrict__ sa, int na,
                 const float* __restrict__ zb, const float* __restrict__ sb, int nb,
                 int n_draw, float inv_s, int last, long long n_rays,
                 float* __restrict__ out_z, float* __restrict__ out_sdf,
                 float* __restrict__ out_new) {
  constexpr int SLICE = 32 * V + V;  // 32 V row slots and their pads
  __shared__ float slice_z[RAYS_PER_BLOCK][SLICE], slice_s[RAYS_PER_BLOCK][SLICE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * RAYS_PER_BLOCK + warp;
  if (r >= n_rays) return;  // the whole warp leaves together
  float* bz = slice_z[warp];
  float* bs = slice_s[warp];
  const float o0 = rays_o[r * 3], o1 = rays_o[r * 3 + 1], o2 = rays_o[r * 3 + 2];
  const float d0 = rays_d[r * 3], d1 = rays_d[r * 3 + 1], d2 = rays_d[r * 3 + 2];
  const int n = na + nb;

  // the rows a then b into the slice, coalesced
  for (int e = lane; e < na; e += 32) {
    bz[at(e)] = za[r * na + e];
    bs[at(e)] = sa[r * na + e];
  }
  for (int e = lane; e < nb; e += 32) {
    bz[at(na + e)] = zb[r * nb + e];
    bs[at(na + e)] = sb[r * nb + e];
  }
  __syncwarp();
  if (nb > 0) {  // stable merge by rank, the sdf riding along
    float mz[V], ms[V];
    int pos[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int e = v * 32 + lane;
      if (e < n) {
        mz[v] = bz[at(e)];
        ms[v] = bs[at(e)];
        pos[v] = e < na ? e + count_below(bz, na, nb, mz[v])
                        : e - na + count_at_or_below(bz, 0, na, mz[v]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (v * 32 + lane < n) {
        bz[at(pos[v])] = mz[v];
        bs[at(pos[v])] = ms[v];
      }
    }
    __syncwarp();
  }
  if (!last) {  // the merged row goes out as it is
    for (int e = lane; e < n; e += 32) {
      out_z[r * n + e] = bz[at(e)];
      out_sdf[r * n + e] = bs[at(e)];
    }
  }

  // lane k takes samples k V .. k V + V - 1; section i joins samples i, i + 1
  float z[V], s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = lane * V + v;
    z[v] = i < n ? bz[at(i)] : 0.0f;
    s[v] = i < n ? bs[at(i)] : 0.0f;
  }
  auto radius = [&](float t) {
    const float px = o0 + d0 * t, py = o1 + d1 * t, pz = o2 + d2 * t;
    return sqrtf(px * px + py * py + pz * pz);
  };
  const float z_right = __shfl_down_sync(FULL, z[0], 1);
  const float s_right = __shfl_down_sync(FULL, s[0], 1);
  const float rad_right = __shfl_down_sync(FULL, radius(z[0]), 1);
  // the cosine's predecessor of this lane's first section: the last of the lane before
  float prev_cos = __shfl_up_sync(FULL, (s_right - s[V - 1]) / (z_right - z[V - 1] + 1e-5f), 1);
  if (lane == 0) prev_cos = 0.0f;

  // w[v] = alpha times this lane's exclusive running product of (1 - alpha + 1e-7)
  float w[V], run = 1.0f, rad = radius(z[0]);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float z1 = v + 1 < V ? z[v + 1] : z_right, s1 = v + 1 < V ? s[v + 1] : s_right;
    const float rad1 = v + 1 < V ? radius(z[v + 1]) : rad_right;
    const bool inside = rad < 1.0f || rad1 < 1.0f;
    rad = rad1;
    const float cos_raw = (s1 - s[v]) / (z1 - z[v] + 1e-5f);
    float c = fminf(prev_cos, cos_raw);
    prev_cos = cos_raw;
    c = inside ? fminf(fmaxf(c, -1e3f), 0.0f) : 0.0f;
    const float mid = (s[v] + s1) * 0.5f, dist = z1 - z[v];
    const float prev_cdf = sigmoid((mid - c * dist * 0.5f) * inv_s);
    const float next_cdf = sigmoid((mid + c * dist * 0.5f) * inv_s);
    const float alpha = (prev_cdf - next_cdf + 1e-5f) / (prev_cdf + 1e-5f);
    w[v] = alpha * run;
    if (lane * V + v < n - 1) run *= 1.0f - alpha + 1e-7f;
  }
  float trans_in = __shfl_up_sync(FULL, warp_scan_prod(run, lane), 1);
  if (lane == 0) trans_in = 1.0f;
  float wsum_lane = 0.0f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    w[v] = lane * V + v < n - 1 ? w[v] * trans_in + 1e-5f : 0.0f;
    wsum_lane += w[v];
  }
  const float wsum = warp_sum(wsum_lane);
  // cdf[0] = 0, cdf[i + 1] = cdf_sec[i]: the inclusive sum of the pdf to section i
  float (&cdf_sec)[V] = w;  // in place
  float acc = 0.0f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    acc += w[v] / wsum;
    cdf_sec[v] = acc;
  }
  float cdf_in = __shfl_up_sync(FULL, warp_scan_sum(acc, lane), 1);
  if (lane == 0) cdf_in = 0.0f;
#pragma unroll
  for (int v = 0; v < V; ++v) cdf_sec[v] += cdf_in;

  // draws: lane takes j = q * 32 + lane; inds = #{m < n : cdf[m] <= u}
  float nz[V];
  if constexpr (V == 1) {
    // here n + n_draw <= 32: one draw a lane, the search a ballot a draw
    const bool valid = lane < n - 1;
    int inds = 0;
    for (int j = 0; j < n_draw; ++j) {
      const float u = (j + 0.5f) / n_draw;
      const unsigned hit = __ballot_sync(FULL, valid && cdf_sec[0] <= u);
      if (lane == j) inds = 1 + __popc(hit);  // cdf[0] = 0 <= u
    }
    const int below = max(inds - 1, 0), above = min(inds, n - 1);
    const float c_lo = __shfl_sync(FULL, cdf_sec[0], max(below - 1, 0));
    const float c_hi = __shfl_sync(FULL, cdf_sec[0], max(above - 1, 0));
    const float z_lo = __shfl_sync(FULL, z[0], below), z_hi = __shfl_sync(FULL, z[0], above);
    const float u = (lane + 0.5f) / n_draw;
    const float lo = below > 0 ? c_lo : 0.0f, hi = above > 0 ? c_hi : 0.0f;
    float denom = hi - lo;
    denom = denom < 1e-5f ? 1.0f : denom;
    nz[0] = z_lo + (u - lo) / denom * (z_hi - z_lo);
  } else {
    __syncwarp();  // the sdf row has been read: the slice's s half takes the cdf row
    if (lane == 0) bs[at(0)] = 0.0f;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (lane * V + v < n - 1) bs[at(lane * V + v + 1)] = cdf_sec[v];
    __syncwarp();
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int j = q * 32 + lane;
      if (q * 32 >= n_draw) break;
      const float u = (j + 0.5f) / n_draw;
      const int inds = count_at_or_below(bs, 0, n, u);
      const int below = max(inds - 1, 0), above = min(inds, n - 1);
      const float lo = bs[at(below)], hi = bs[at(above)];
      const float z_lo = bz[at(below)], z_hi = bz[at(above)];
      float denom = hi - lo;
      denom = denom < 1e-5f ? 1.0f : denom;
      nz[q] = z_lo + (u - lo) / denom * (z_hi - z_lo);
    }
  }

  if (!last) {
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int j = q * 32 + lane;
      if (j < n_draw) out_new[r * n_draw + j] = nz[q];
    }
    return;
  }
  // the last round: merge the draws (b) into the row (a) by rank, each
  // value written at its rank in the output row
  __syncwarp();  // every read of the cdf row is done
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int j = q * 32 + lane;
    if (j < n_draw) bs[at(j)] = nz[q];
  }
  __syncwarp();
  const int n_out = n + n_draw;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int e = v * 32 + lane;
    if (e < n) {
      const float za_e = bz[at(e)];
      out_z[r * n_out + e + count_below(bs, 0, n_draw, za_e)] = za_e;
    }
    if (e < n_draw) out_z[r * n_out + e + count_at_or_below(bz, 0, n, nz[v])] = nz[v];
  }
}

template <int V>
void launch(const float* rays_o, const float* rays_d, const float* za, const float* sa, int na,
            const float* zb, const float* sb, int nb, int n_draw, float inv_s, int last,
            long long n_rays, float* out_z, float* out_sdf, float* out_new, cudaStream_t stream) {
  const long long blocks = (n_rays + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK;
  up_sample_kernel<V><<<(unsigned)blocks, RAYS_PER_BLOCK * 32, 0, stream>>>(
      rays_o, rays_d, za, sa, na, zb, sb, nb, n_draw, inv_s, last, n_rays, out_z, out_sdf,
      out_new);
}

}  // namespace

// Returns a cudaError_t value (0 = launched), or -1 for rows wider than
// MAX_WIDTH (na + nb + n_draw). zb / sb may be null with nb == 0. On the
// last round out_z is (R, na + nb + n_draw) and out_sdf / out_new are
// unused; otherwise out_z, out_sdf are (R, na + nb) and out_new is
// (R, n_draw).
extern "C" int nw_up_sample(const float* rays_o, const float* rays_d, const float* za,
                            const float* sa, int na, const float* zb, const float* sb, int nb,
                            int n_draw, float inv_s, int last, long long n_rays, float* out_z,
                            float* out_sdf, float* out_new, void* stream) {
  const int width = na + nb + n_draw;
  if (na < 1 || nb < 0 || n_draw < 1 || width > MAX_WIDTH) return -1;
  if (n_rays <= 0) return 0;
  auto* fn = width <= 32 ? &launch<1> : width <= 64 ? &launch<2> : width <= 128 ? &launch<4>
           : width <= 256 ? &launch<8> : width <= 512 ? &launch<16> : &launch<32>;
  fn(rays_o, rays_d, za, sa, na, zb, sb, nb, n_draw, inv_s, last, n_rays, out_z, out_sdf,
     out_new, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
