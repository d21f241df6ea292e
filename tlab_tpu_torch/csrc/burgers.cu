// Fused Burgers term res_f = nu_f * D2(x_f) - c * D1(x_f) along one axis of
// the stacked fields x (F, nx, ny, nz); fp32 in and out.
//
// Replaces the Pallas TPU kernels of tlab_tpu/ops/pallas_burgers.py
// (_kern_x, _kern_y, _kern_z).  On an H100 the dense [D1; D2] product is
// bound by operations, not bytes (see tlab_tpu_torch/ops/burgers.py), so
// what matters is the unit the product runs on.
//
// K1 and K2 (column form, D @ X) run on the tensor cores: wgmma with TF32
// operands and the 3-pass split x = x_hi + x_lo, d = d_hi + d_lo,
// x_lo.d_hi + x_hi.d_lo + x_hi.d_hi into fp32 accumulators, the Hopper
// counterpart of the Pallas kernel's 3-pass bf16 split (_dot).  hi + lo
// carries ~22 significant bits and the dropped lo.lo term is ~2^-22
// relative, so the result stays within fp32 round-off of a full-fp32
// product.  See the note above tc::burgers_col.
//
// K3 (row form, X @ D^T) is still an fp32-FMA tiled product: each block
// computes a 128 x 64 output tile, each of its 256 threads an 8 x 4
// sub-tile, with the operator streamed through shared memory in K-tiles of
// 16 beside the field tile.
//
// In all three, two accumulators (the D1 rows and the D2 rows of the same
// output tile) are combined with nu_f and the matching conv element in the
// epilogue, so the 2F-field product never reaches device memory.  Ragged
// edges are masked: loads outside the array read 0, stores outside it are
// skipped.
//
// Entry points: plain C, launched on the caller's stream, returning
// cudaGetLastError().
//   burgers_x  K1  contracts axis 0: column form D @ X_f, X_f = (nx, ny*nz)
//   burgers_y  K2  contracts axis 1: column form D @ X_fi, X_fi = (ny, nz)
//   burgers_z  K3  contracts axis 2: row form X @ D^T, X = (F*nx*ny, nz)

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// tiles of the fp32-FMA row kernel (K3)
constexpr int kThreads = 256;   // 16 x 16
constexpr int kTM = 8;          // output rows per thread
constexpr int kTN = 4;          // output columns per thread
constexpr int kBM = 16 * kTM;   // 128 output rows per block
constexpr int kBN = 16 * kTN;   // 64 output columns per block
constexpr int kBK = 16;         // contraction depth per shared-memory stage
constexpr int kPad = 4;         // keeps rows 16-byte aligned, spreads banks

__device__ __forceinline__ void load8(float (&r)[8], const float* p) {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
    r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ void load4(float (&r)[4], const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
    return ((reinterpret_cast<uintptr_t>(a) |
             reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// nu * d2 - c * d1 for kTN consecutive outputs at o[0..cols), with conv at
// cv[0..cols); one 16-byte access each when the whole group is in range.
__device__ __forceinline__ void combine_store(
        float* o, const float* cv, const float (&d1)[kTN],
        const float (&d2)[kTN], float nu_f, int cols, bool vec) {
    if (vec && cols >= kTN) {
        const float4 c = *reinterpret_cast<const float4*>(cv);
        float4 r;
        r.x = nu_f * d2[0] - c.x * d1[0];
        r.y = nu_f * d2[1] - c.y * d1[1];
        r.z = nu_f * d2[2] - c.z * d1[2];
        r.w = nu_f * d2[3] - c.w * d1[3];
        *reinterpret_cast<float4*>(o) = r;
        return;
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j)
        if (j < cols) o[j] = nu_f * d2[j] - cv[j] * d1[j];
}

// ---------------------------------------------------------------------------
// Column form (K1, K2) on the tensor cores, 3xTF32.
//
// Batch b = f * G + g.  For each b the (n, C) output slab is
// out_b = nu_f * (D2 @ X_b) - conv_g .* (D1 @ X_b), with X_b, conv_g, out_b
// row-major (n, C) slabs.  K1: G = 1, C = ny*nz.  K2: G = nx, C = nz.
//
// wgmma takes 32-bit operands from shared memory only K-major, and the field
// tile (k, c) has c contiguous, so a block computes the transposed tile
// out^T(c, a) = X^T(c, k) . D^T(k, a): A = X^T comes from registers (each
// thread reads its fragment elements from the plain (k, c) tile in shared
// memory and splits them into hi + lo there), B = the operator rows, which
// are K-major as they stand.  The operator is split once on the host side
// into `pack`: for each (row tile, K tile) the four kTA x kKT tiles D1 hi,
// D1 lo, D2 hi, D2 lo, zero-padded, already in the 64-byte-swizzled
// core-matrix layout their wgmma descriptor names, so a stage's operator
// tiles are one contiguous 32 KB copy.
//
// A block of two warpgroups owns 128 columns c (64 each) x 128 operator rows
// a and two fp32 accumulators per thread (D1 rows, D2 rows; 2 x 64
// registers).  A ring of kStages shared-memory stages is filled by cp.async
// kStages - 2 K tiles ahead; each K tile is one commit group of 12 wgmma
// (2 k-steps x {D1, D2} x {x_lo.d_hi, x_hi.d_lo, x_hi.d_hi}), and the
// fragments of tile t+1 are read and split while the products of tile t
// run (two register sets, wait_group 1).  The epilogue stages both
// accumulators through the ring's memory, transposed back, and writes
// 16-byte rows of out, reading conv the same way; the conv tile is asked
// into L2 a few K tiles before, and the blocks are ordered so that those
// sharing a field tile or a conv tile run side by side.
//
// What holds it back now (H100, 512x256x256): with the loads taken out the
// K loop runs at ~92% of the TF32 peak, but each block's prologue and
// epilogue (~0.7 ms over a launch) overlap nothing, since the 2 x 64
// accumulator registers allow one block an SM; the loads (~41 KB a K tile
// from L2) slow the loop by another ~20%.
namespace tc {

constexpr int kTC = 128;             // columns c per block (2 warpgroups x 64)
constexpr int kTA = 128;             // operator rows per block (wgmma N)
constexpr int kKT = 16;              // contraction depth per stage (64 bytes)
constexpr int kStages = 5;
constexpr int kPrefetch = 8;         // K tiles between asking for conv and using it
constexpr int kThreads = 256;
constexpr int kXS = kTC + 8;         // field-tile row stride, = 8 (mod 32)
constexpr int kOS = kTC + 4;         // epilogue row stride, = 4 (mod 32)
constexpr int kOpSub = kTA * kKT;    // floats in one operator tile (8 KB)
constexpr int kOpStage = 4 * kOpSub; // D1 hi, D1 lo, D2 hi, D2 lo
constexpr int kXStage = kKT * kXS;
constexpr int kRing = kStages * (kOpStage + kXStage);   // floats
constexpr int kSmemBytes = kRing * 4 + 1024;            // + alignment slack
static_assert(2 * kTA * kOS <= kRing, "epilogue tiles must fit in the ring");
static_assert(kKT * 4 == 64, "the pack is laid out for the 64-byte swizzle");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; bytes beyond src_bytes (0 or 16) are written as zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// makes this thread's shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Descriptor of a K-major operator tile in the 64-byte swizzle: rows of 64
// bytes, 8-row groups 512 bytes apart (SBO), LBO unused (1), layout type 2.
__device__ __forceinline__ uint64_t op_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(512 >> 4) << 32)
         | (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
    return r;
}

// d (64 x 128, fp32) += A (64 x 8, TF32, registers) . B (8 x 128, TF32,
// shared memory through its descriptor)
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Start the copies of K tile t into its stage: the four operator tiles
// (contiguous in pack) and the (kKT, kTC) field tile, zero beyond n and C.
__device__ __forceinline__ void load_stage(
        float* ring, const float* pack_tiles, const float* xb, int t,
        int n, int C, int c0, bool xvec, int tid) {
    const int s = t % kStages;
    const uint32_t op = smem_u32(ring + s * kOpStage);
    const float* src = pack_tiles + (size_t)t * kOpStage;
#pragma unroll
    for (int i = 0; i < kOpStage / 4 / kThreads; ++i) {
        const int e = (tid + i * kThreads) * 4;
        cp_async16(op + e * 4, src + e, 16);
    }
    const uint32_t xs = smem_u32(ring + kStages * kOpStage + s * kXStage);
    const int k0 = t * kKT;
    if (xvec) {
#pragma unroll
        for (int i = 0; i < kKT * kTC / 4 / kThreads; ++i) {
            const int e = tid + i * kThreads;
            const int kk = e / (kTC / 4), cc = (e % (kTC / 4)) * 4;
            const int k = k0 + kk, c = c0 + cc;
            const bool ok = k < n && c < C;
            cp_async16(xs + (kk * kXS + cc) * 4,
                       ok ? xb + (size_t)k * C + c : xb, ok ? 16 : 0);
        }
    } else {
        for (int e = tid; e < kKT * kTC; e += kThreads) {
            const int kk = e / kTC, cc = e % kTC;
            const int k = k0 + kk, c = c0 + cc;
            const bool ok = k < n && c < C;
            cp_async4(xs + (kk * kXS + cc) * 4,
                      ok ? xb + (size_t)k * C + c : xb, ok ? 4 : 0);
        }
    }
}

// One K tile: read this thread's A fragments from the field tile, split
// them, and start the tile's 12 products as one commit group.
__device__ __forceinline__ void tile_products(
        const float* ring, int t, int frag0, float (&acc1)[64],
        float (&acc2)[64], uint32_t (&hi)[kKT / 8][4],
        uint32_t (&lo)[kKT / 8][4]) {
    const int s = t % kStages;
    const float* xs = ring + kStages * kOpStage + s * kXStage + frag0;
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
        // a0 (m, k), a1 (m + 8, k), a2 (m, k + 4), a3 (m + 8, k + 4)
        const float v[4] = {xs[(j * 8) * kXS], xs[(j * 8) * kXS + 8],
                            xs[(j * 8 + 4) * kXS], xs[(j * 8 + 4) * kXS + 8]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            hi[j][i] = to_tf32(v[i]);
            lo[j][i] = to_tf32(v[i] - __uint_as_float(hi[j][i]));
        }
    }
    const uint32_t op = smem_u32(ring + s * kOpStage);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
        // a k-step of 8 is 32 bytes further along each 64-byte row
        const uint64_t d1h = op_desc(op + j * 32);
        const uint64_t d1l = op_desc(op + kOpSub * 4 + j * 32);
        const uint64_t d2h = op_desc(op + 2 * kOpSub * 4 + j * 32);
        const uint64_t d2l = op_desc(op + 3 * kOpSub * 4 + j * 32);
        wgmma_m64n128k8(acc1, lo[j], d1h);      // the two small terms first
        wgmma_m64n128k8(acc2, lo[j], d2h);
        wgmma_m64n128k8(acc1, hi[j], d1l);
        wgmma_m64n128k8(acc2, hi[j], d2l);
        wgmma_m64n128k8(acc1, hi[j], d1h);
        wgmma_m64n128k8(acc2, hi[j], d2h);
    }
    wgmma_commit();
}

// Iteration t of the ring: wait for K tile t, start the copies of tile
// t + kStages - 2 into the stage that tile t - 2 has left, start tile t's
// products, and wait until tile t - 1's are done.
__device__ __forceinline__ void ring_step(
        float* ring, const float* pack_tiles, const float* xb, int t, int kt,
        int n, int C, int c0, bool xvec, int tid, int frag0,
        float (&acc1)[64], float (&acc2)[64], uint32_t (&hi)[kKT / 8][4],
        uint32_t (&lo)[kKT / 8][4]) {
    cp_async_wait<kStages - 3>();
    fence_async_shared();
    __syncthreads();
    if (t + kStages - 2 < kt)
        load_stage(ring, pack_tiles, xb, t + kStages - 2, n, C, c0, xvec,
                   tid);
    cp_async_commit();
    tile_products(ring, t, frag0, acc1, acc2, hi, lo);
    wgmma_wait<1>();
}

__global__ void __launch_bounds__(kThreads, 1)
burgers_col(const float* __restrict__ pack, const float* __restrict__ x,
            const float* __restrict__ conv, const float* __restrict__ nu,
            float* __restrict__ out, int n, int C, int G, int F, int a_tiles,
            int c_tiles)
{
    extern __shared__ unsigned char smem_raw[];
    // the swizzle works on address bits: align the ring to 1024 bytes
    float* ring = reinterpret_cast<float*>(
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, q = lane % 4;
    // Operator-row tiles vary fastest, then the fields: the blocks that
    // share a field tile, and after them those that share a conv tile, run
    // side by side and find it in L2.
    int rest = blockIdx.x;
    const int a_tile = rest % a_tiles;
    rest /= a_tiles;
    const int f = rest % F;
    rest /= F;
    const int a0 = a_tile * kTA;
    const int c0 = (rest % c_tiles) * kTC;
    const int g_slab = rest / c_tiles;
    const int b = f * G + g_slab;
    const size_t slab = (size_t)n * C;
    const float* xb = x + (size_t)b * slab;
    const int kt = (n + kKT - 1) / kKT;
    const float* pack_tiles = pack + (size_t)a_tile * kt * kOpStage;
    const bool xvec = (C % 4) == 0 &&
        (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    // this thread's rows of A: m = 16 * warp + g (+ 8), column k = q (+ 4)
    const int m = warp * 16 + g;
    const int frag0 = q * kXS + m;

    const float* cg = conv + (size_t)g_slab * slab;

    float acc1[64], acc2[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) { acc1[i] = 0.f; acc2[i] = 0.f; }
    uint32_t hi_a[kKT / 8][4], lo_a[kKT / 8][4];
    uint32_t hi_b[kKT / 8][4], lo_b[kKT / 8][4];

#pragma unroll
    for (int t = 0; t < kStages - 2; ++t) {
        if (t < kt)
            load_stage(ring, pack_tiles, xb, t, n, C, c0, xvec, tid);
        cp_async_commit();
    }
    // The epilogue's conv tile is asked into L2 (128-byte lines) kPrefetch
    // K tiles before the end, so that its trip from device memory overlaps
    // the products and the field tiles streaming through L2 meanwhile do
    // not push it out again.  The F blocks that share the tile run side by
    // side, and the first of them asks.
    const int ask_at = f == 0 ? (kt > kPrefetch ? (kt - kPrefetch) & ~1 : 0)
                              : -1;
    // two tiles per trip, so that each has its own fragment registers
    for (int t = 0; t < kt; t += 2) {
        if (t == ask_at)
            for (int i = tid; i < kTA * (kTC / 32); i += kThreads) {
                const int a = a0 + i / (kTC / 32);
                const int c = c0 + (i % (kTC / 32)) * 32;
                if (a < n && c < C) prefetch_l2(cg + (size_t)a * C + c);
            }
        ring_step(ring, pack_tiles, xb, t, kt, n, C, c0, xvec, tid, frag0,
                  acc1, acc2, hi_a, lo_a);
        if (t + 1 < kt)
            ring_step(ring, pack_tiles, xb, t + 1, kt, n, C, c0, xvec, tid,
                      frag0, acc1, acc2, hi_b, lo_b);
    }
    wgmma_wait<0>();
    cp_async_wait<0>();
    __syncthreads();

    // the accumulators hold out^T: d[4j + 2h + e] is (c = m + 8h,
    // a = 8j + 2q + e).  Store them as (a, c) tiles, then combine by rows.
    float* s1 = ring;
    float* s2 = ring + kTA * kOS;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int o = (8 * j + 2 * q + e) * kOS + m + 8 * h;
                s1[o] = acc1[4 * j + 2 * h + e];
                s2[o] = acc2[4 * j + 2 * h + e];
            }
    __syncthreads();

    const float nu_f = nu[f];
    float* ob = out + (size_t)b * slab;
    const bool vec = (C % 4) == 0 && aligned16(cg, ob);
    for (int i = tid; i < kTA * (kTC / 4); i += kThreads) {
        const int aa = i / (kTC / 4), cc = (i % (kTC / 4)) * 4;
        const int a = a0 + aa, c = c0 + cc;
        if (a >= n || c >= C) continue;
        float d1[kTN], d2[kTN];
        load4(d1, &s1[aa * kOS + cc]);
        load4(d2, &s2[aa * kOS + cc]);
        const size_t o = (size_t)a * C + c;
        combine_store(ob + o, cg + o, d1, d2, nu_f, C - c, vec);
    }
}

}  // namespace tc

// Row form (K3).  X is (R, n) row-major with R = F * P rows (P = nx*ny rows
// per field); out[r, a] = nu[r / P] * (X D2^T)[r, a]
//                         - conv[r % P, a] * (X D1^T)[r, a].
__global__ void __launch_bounds__(kThreads)
burgers_row(const float* __restrict__ d12, const float* __restrict__ x,
            const float* __restrict__ conv, const float* __restrict__ nu,
            float* __restrict__ out, int n, int R, int P, int col_tiles)
{
    __shared__ __align__(16) float s_x[kBK][kBM + kPad];
    __shared__ __align__(16) float s_d1[kBK][kBN + kPad];
    __shared__ __align__(16) float s_d2[kBK][kBN + kPad];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    // operator-column tiles vary fastest (the same field rows stay in L2)
    const int a0 = (blockIdx.x % col_tiles) * kBN;
    const int r0 = (blockIdx.x / col_tiles) * kBM;

    float acc1[kTM][kTN] = {};
    float acc2[kTM][kTN] = {};

    for (int k0 = 0; k0 < n; k0 += kBK) {
        for (int e = tid; e < kBM * kBK; e += kThreads) {
            const int m = e / kBK, kk = e % kBK;
            const int r = r0 + m, k = k0 + kk;
            s_x[kk][m] = (r < R && k < n) ? x[(size_t)r * n + k] : 0.f;
        }
        for (int e = tid; e < kBN * kBK; e += kThreads) {
            const int aa = e / kBK, kk = e % kBK;
            const int a = a0 + aa, k = k0 + kk;
            const bool ok = a < n && k < n;
            s_d1[kk][aa] = ok ? d12[(size_t)a * n + k] : 0.f;
            s_d2[kk][aa] = ok ? d12[(size_t)(a + n) * n + k] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
            float rx[kTM], r1[kTN], r2[kTN];
            load8(rx, &s_x[kk][ty * kTM]);
            load4(r1, &s_d1[kk][tx * kTN]);
            load4(r2, &s_d2[kk][tx * kTN]);
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
                for (int j = 0; j < kTN; ++j) {
                    acc1[i][j] = fmaf(rx[i], r1[j], acc1[i][j]);
                    acc2[i][j] = fmaf(rx[i], r2[j], acc2[i][j]);
                }
        }
        __syncthreads();
    }

    const bool vec = (n % 4) == 0 && aligned16(conv, out);
    const int a = a0 + tx * kTN;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
        const int r = r0 + ty * kTM + i;
        if (r < R && a < n) {
            const size_t o = (size_t)r * n + a;
            const size_t co = (size_t)(r % P) * n + a;
            combine_store(out + o, conv + co, acc1[i], acc2[i], nu[r / P],
                          n - a, vec);
        }
    }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// F * G batches of (n, C) slabs through the tensor-core column kernel
int launch_col(const float* pack, const float* x, const float* conv,
               const float* nu, float* out, int n, int C, int G, int F,
               void* stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        tc::burgers_col, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int at = ceil_div(n, tc::kTA), ct = ceil_div(C, tc::kTC);
    const long long blocks = (long long)at * ct * F * G;
    if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    tc::burgers_col<<<static_cast<unsigned>(blocks), tc::kThreads,
                      tc::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
        pack, x, conv, nu, out, n, C, G, F, at, ct);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tile sizes of the split operator that burgers_x and burgers_y take as
// `pack` (see tlab_tpu_torch/ops/burgers.py::pack_operator).
extern "C" void burgers_col_tiles(int* rows, int* depth)
{
    *rows = tc::kTA;
    *depth = tc::kKT;
}

extern "C" int burgers_x(const float* pack, const float* x, const float* conv,
                         const float* nu, float* out, int F, int nx, int ny,
                         int nz, void* stream)
{
    return launch_col(pack, x, conv, nu, out, nx, ny * nz, 1, F, stream);
}

extern "C" int burgers_y(const float* pack, const float* x, const float* conv,
                         const float* nu, float* out, int F, int nx, int ny,
                         int nz, void* stream)
{
    return launch_col(pack, x, conv, nu, out, ny, nz, nx, F, stream);
}

extern "C" int burgers_z(const float* d12, const float* x, const float* conv,
                         const float* nu, float* out, int F, int nx, int ny,
                         int nz, void* stream)
{
    const int n = nz, P = nx * ny, R = F * P;
    const int ct = ceil_div(n, kBN);
    dim3 grid(ct * ceil_div(R, kBM));
    burgers_row<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        d12, x, conv, nu, out, n, R, P, ct);
    return static_cast<int>(cudaGetLastError());
}
