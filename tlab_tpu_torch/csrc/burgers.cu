// Fused Burgers term res_f = nu_f * D2(x_f) - c * D1(x_f) along one axis of
// the stacked fields x (F, nx, ny, nz); fp32 in and out, fp32 FMA.
//
// Replaces the Pallas TPU kernels of tlab_tpu/ops/pallas_burgers.py
// (_kern_x, _kern_y, _kern_z).  On an H100 the dense [D1; D2] product is
// bound by fp32 FMA throughput (see tlab_tpu_torch/ops/burgers.py).  Each
// block computes a 128 x 64 output tile; each of its 256 threads owns an
// 8 x 4 sub-tile and two register accumulators, one for the D1 rows and one
// for the D2 rows of the operator, and combines them with nu_f and the
// matching conv element in the epilogue, so the 2F-field product never
// reaches device memory.  The operator cannot stay resident as it does in
// VMEM (2 MiB at n = 512), so it streams through shared memory in K-tiles
// of 16 beside the field tile.  Ragged edges are masked: loads outside the
// array read 0, stores outside it are skipped.
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

// Column form.  Batch b = f * G + g.  For each b the (n, C) output slab is
// out_b = nu_f * (D2 @ X_b) - conv_g .* (D1 @ X_b), with X_b, conv_g, out_b
// row-major (n, C) slabs and D1, D2 the two (n, n) halves of d12.
// K1: G = 1, C = ny*nz.  K2: G = nx, C = nz.
__global__ void __launch_bounds__(kThreads)
burgers_col(const float* __restrict__ d12, const float* __restrict__ x,
            const float* __restrict__ conv, const float* __restrict__ nu,
            float* __restrict__ out, int n, int C, int G, int row_tiles)
{
    __shared__ __align__(16) float s_d1[kBK][kBM + kPad];
    __shared__ __align__(16) float s_d2[kBK][kBM + kPad];
    __shared__ __align__(16) float s_x[kBK][kBN];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    // operator-row tiles vary fastest: the blocks that share a field tile
    // run side by side and find it in L2
    const int a0 = (blockIdx.x % row_tiles) * kBM;
    const int c0 = (blockIdx.x / row_tiles) * kBN;
    const int b = blockIdx.y;
    const float nu_f = nu[b / G];
    const size_t slab = (size_t)n * C;
    const float* xb = x + (size_t)b * slab;

    float acc1[kTM][kTN] = {};
    float acc2[kTM][kTN] = {};

    for (int k0 = 0; k0 < n; k0 += kBK) {
        for (int e = tid; e < kBM * kBK; e += kThreads) {
            const int m = e / kBK, kk = e % kBK;
            const int a = a0 + m, k = k0 + kk;
            const bool ok = a < n && k < n;
            s_d1[kk][m] = ok ? d12[(size_t)a * n + k] : 0.f;
            s_d2[kk][m] = ok ? d12[(size_t)(a + n) * n + k] : 0.f;
        }
        for (int e = tid; e < kBK * kBN; e += kThreads) {
            const int kk = e / kBN, cc = e % kBN;
            const int k = k0 + kk, c = c0 + cc;
            s_x[kk][cc] = (k < n && c < C) ? xb[(size_t)k * C + c] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
            float r1[kTM], r2[kTM], rx[kTN];
            load8(r1, &s_d1[kk][ty * kTM]);
            load8(r2, &s_d2[kk][ty * kTM]);
            load4(rx, &s_x[kk][tx * kTN]);
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
                for (int j = 0; j < kTN; ++j) {
                    acc1[i][j] = fmaf(r1[i], rx[j], acc1[i][j]);
                    acc2[i][j] = fmaf(r2[i], rx[j], acc2[i][j]);
                }
        }
        __syncthreads();
    }

    const float* cg = conv + (size_t)(b % G) * slab;
    float* ob = out + (size_t)b * slab;
    const bool vec = (C % 4) == 0 && aligned16(cg, ob);
    const int c = c0 + tx * kTN;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
        const int a = a0 + ty * kTM + i;
        if (a < n && c < C) {
            const size_t o = (size_t)a * C + c;
            combine_store(ob + o, cg + o, acc1[i], acc2[i], nu_f, C - c, vec);
        }
    }
}

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

}  // namespace

extern "C" int burgers_x(const float* d12, const float* x, const float* conv,
                         const float* nu, float* out, int F, int nx, int ny,
                         int nz, void* stream)
{
    const int n = nx, C = ny * nz;
    const int rt = ceil_div(n, kBM);
    dim3 grid(rt * ceil_div(C, kBN), F);
    burgers_col<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        d12, x, conv, nu, out, n, C, 1, rt);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int burgers_y(const float* d12, const float* x, const float* conv,
                         const float* nu, float* out, int F, int nx, int ny,
                         int nz, void* stream)
{
    const int n = ny, C = nz;
    const int rt = ceil_div(n, kBM);
    dim3 grid(rt * ceil_div(C, kBN), F * nx);
    burgers_col<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        d12, x, conv, nu, out, n, C, nx, rt);
    return static_cast<int>(cudaGetLastError());
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
