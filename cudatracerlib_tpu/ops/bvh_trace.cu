// BVH traversal kernel: one thread per ray over the fat-node BVH.
//
// Counterpart of the reference's Aila-Laine while-while traversal
// (Kernel/TraceHelper.cu:326-746, intersectKernel<ANY_HIT>). Reads the arrays
// accel/bvh.py builds, unchanged:
//   nodes (M, 16) f32: [c0.min, c0.max, c1.min, c1.max, c0_code, c1_code, pad,
//                       pad], child codes bitcast int32; code >= 0 is an inner
//                       node, code < 0 a leaf whose first triangle is
//                       -(code + 1);
//   woop  (T, 12) f32: Woop rows r0 | r1 | r2, LEAF_SIZE rows per leaf;
//   root  (1,) i32   : root child code.
// Rays come packed as (B, 8) f32 [ox oy oz t_min dx dy dz t_max]; hits go out
// as (B, 4) f32 [t u v prim] with prim bitcast int32 (-1 and t = t_max on a
// miss). The arithmetic is the XLA oracle's (accel/traversal.py intersect):
// the same slab test, near-first order and Woop test, so the two agree up to
// rounding.
//
// One thread per ray in a plain grid. The reference's persistent warps with
// work stealing measured the same on an H100 (PERF.md), so there is one
// launch scheme. The handlers only enqueue work on XLA's stream.
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kStackDepth = 64;  // == accel/traversal.py STACK_DEPTH
constexpr int kLeafSize = 4;     // == accel/bvh.py LEAF_SIZE
constexpr int kBlock = 128;      // 32 x 4, the reference's launch shape

__device__ __forceinline__ float safe_inv(float x) {
  const float y = fabsf(x) < 1e-20f ? (x < 0.0f ? -1e-20f : 1e-20f) : x;
  return 1.0f / y;
}

struct Ray {
  float ox, oy, oz, t_min, dx, dy, dz, t_max;
  float ix, iy, iz;  // safe reciprocal direction
};

// Slab test of one child box; returns whether [near, far] overlaps
// [t_min, t_hit] and writes the unclamped entry distance.
__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly,
                                     float lz, float hx, float hy, float hz,
                                     float t_hit, float* near_out) {
  const float t0x = (lx - r.ox) * r.ix, t1x = (hx - r.ox) * r.ix;
  const float t0y = (ly - r.oy) * r.iy, t1y = (hy - r.oy) * r.iy;
  const float t0z = (lz - r.oz) * r.iz, t1z = (hz - r.oz) * r.iz;
  const float near =
      fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float far =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  *near_out = near;
  return fmaxf(near, r.t_min) <= fminf(far, t_hit);
}

template <bool kAnyHit>
__device__ void trace_one(const float4* __restrict__ nodes,
                          const float4* __restrict__ woop, int n_woop,
                          int root, const float4* __restrict__ rays,
                          float4* __restrict__ hits, int i) {
  const float4 a = __ldg(rays + 2 * i);
  const float4 b = __ldg(rays + 2 * i + 1);
  Ray r;
  r.ox = a.x; r.oy = a.y; r.oz = a.z; r.t_min = a.w;
  r.dx = b.x; r.dy = b.y; r.dz = b.z; r.t_max = b.w;
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);

  float t_hit = r.t_max, hu = 0.0f, hv = 0.0f;
  int prim = -1;
  // A non-finite origin or direction misses, as it does in the oracle
  // (every comparison with NaN is false there).
  const bool finite = isfinite(r.ox) && isfinite(r.oy) && isfinite(r.oz) &&
                      isfinite(r.dx) && isfinite(r.dy) && isfinite(r.dz);
  int stack[kStackDepth];
  int sp = 0;
  int code = root;
  bool done = !finite;
  while (!done) {
    // inner nodes: descend near-first until a leaf or an empty stack
    while (code >= 0) {
      const float4* n = nodes + 4 * code;
      const float4 n0 = __ldg(n), n1 = __ldg(n + 1), n2 = __ldg(n + 2),
                   n3 = __ldg(n + 3);
      float near0, near1;
      const bool h0 = slab(r, n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, t_hit,
                           &near0);
      const bool h1 = slab(r, n1.z, n1.w, n2.x, n2.y, n2.z, n2.w, t_hit,
                           &near1);
      const int c0 = __float_as_int(n3.x), c1 = __float_as_int(n3.y);
      if (h0 || h1) {
        const bool swap = h1 && (!h0 || near1 < near0);
        if (h0 && h1 && sp < kStackDepth) stack[sp++] = swap ? c0 : c1;
        code = swap ? c1 : c0;
      } else if (sp > 0) {
        code = stack[--sp];
      } else {
        done = true;
        break;
      }
    }
    if (done) break;
    // leaf: LEAF_SIZE Woop tests; a strict t < t_hit keeps the first of
    // equal distances, as the oracle's argmin does
    const int first = -(code + 1);
    bool leaf_hit = false;
#pragma unroll
    for (int k = 0; k < kLeafSize; ++k) {
      const int tri = min(first + k, n_woop - 1);
      const float4* w = woop + 3 * tri;
      const float4 r0 = __ldg(w), r1 = __ldg(w + 1), r2 = __ldg(w + 2);
      const float oz = r2.x * r.ox + r2.y * r.oy + r2.z * r.oz + r2.w;
      const float dz = r2.x * r.dx + r2.y * r.dy + r2.z * r.dz;
      const float t = -oz * (1.0f / (fabsf(dz) < 1e-20f ? 1e-20f : dz));
      const float u = (r0.x * r.ox + r0.y * r.oy + r0.z * r.oz) + r0.w +
                      t * (r0.x * r.dx + r0.y * r.dy + r0.z * r.dz);
      const float v = (r1.x * r.ox + r1.y * r.oy + r1.z * r.oz) + r1.w +
                      t * (r1.x * r.dx + r1.y * r.dy + r1.z * r.dz);
      if (t > r.t_min && t < t_hit && u >= 0.0f && v >= 0.0f &&
          u + v <= 1.0f && isfinite(t)) {
        t_hit = t; hu = u; hv = v; prim = tri;
        leaf_hit = true;
      }
    }
    if (kAnyHit && leaf_hit) break;
    if (sp > 0) {
      code = stack[--sp];
    } else {
      done = true;
    }
  }
  hits[i] = make_float4(t_hit, hu, hv, __int_as_float(prim));
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    trace_rays(const float4* __restrict__ nodes,
                const float4* __restrict__ woop, int n_woop,
                const int* __restrict__ root, const float4* __restrict__ rays,
                float4* __restrict__ hits, int n_rays) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  trace_one<kAnyHit>(nodes, woop, n_woop, __ldg(root), rays, hits, i);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <bool kAnyHit>
ffi::Error TraceImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                     ffi::Buffer<ffi::F32> woop, ffi::Buffer<ffi::S32> root,
                     ffi::Buffer<ffi::F32> rays,
                     ffi::ResultBuffer<ffi::F32> hits) {
  const std::int64_t n_rays = rays.element_count() / 8;
  const std::int64_t n_woop = woop.element_count() / 12;
  if (rays.element_count() % 8 != 0 || woop.element_count() % 12 != 0 ||
      nodes.element_count() % 16 != 0 ||
      hits->element_count() != 4 * n_rays || n_rays > INT32_MAX ||
      n_woop < 1 || n_woop > INT32_MAX) {
    return ffi::Error::InvalidArgument("bvh_trace: bad operand shapes");
  }
  if (!aligned16(nodes.typed_data()) || !aligned16(woop.typed_data()) ||
      !aligned16(rays.typed_data()) || !aligned16(hits->typed_data())) {
    return ffi::Error::InvalidArgument("bvh_trace: buffers not 16-byte aligned");
  }
  if (n_rays == 0) return ffi::Error::Success();
  const auto* nd = reinterpret_cast<const float4*>(nodes.typed_data());
  const auto* wp = reinterpret_cast<const float4*>(woop.typed_data());
  const auto* ry = reinterpret_cast<const float4*>(rays.typed_data());
  auto* out = reinterpret_cast<float4*>(hits->typed_data());
  const int n = static_cast<int>(n_rays);
  trace_rays<kAnyHit><<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      nd, wp, static_cast<int>(n_woop), root.typed_data(), ry, out, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

#define BVH_TRACE_HANDLER(NAME, ANY)                                        \
  XLA_FFI_DEFINE_HANDLER_SYMBOL(NAME, TraceImpl<ANY>,                       \
                                ffi::Ffi::Bind()                            \
                                    .Ctx<ffi::PlatformStream<cudaStream_t>>() \
                                    .Arg<ffi::Buffer<ffi::F32>>()           \
                                    .Arg<ffi::Buffer<ffi::F32>>()           \
                                    .Arg<ffi::Buffer<ffi::S32>>()           \
                                    .Arg<ffi::Buffer<ffi::F32>>()           \
                                    .Ret<ffi::Buffer<ffi::F32>>());

BVH_TRACE_HANDLER(BvhTraceClosest, false)
BVH_TRACE_HANDLER(BvhTraceAny, true)
