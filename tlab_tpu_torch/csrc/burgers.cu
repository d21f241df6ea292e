// Fused Burgers term res_f = nu_f * D2(x_f) - c * D1(x_f) along one axis of
// the stacked fields x (F, nx, ny, nz); fp32 in and out.
//
// Replaces the Pallas TPU kernels of tlab_tpu/ops/pallas_burgers.py
// (_kern_x, _kern_y, _kern_z).  On an H100 the dense [D1; D2] product is
// bound by operations, not bytes (see tlab_tpu_torch/ops/burgers.py), so
// what matters is the unit the product runs on.
//
// All three run on the tensor cores, in one of three arithmetic contracts,
// those of the Pallas kernel's _dot (pallas_burgers.py:38-58) as the port
// names them (ops/derivative.py::op_precision):
//   "highest"  wgmma with TF32 operands and the 3-pass split
//              x = x_hi + x_lo, d = d_hi + d_lo, x_lo.d_hi + x_hi.d_lo +
//              x_hi.d_hi into fp32 accumulators.  hi + lo carries ~22
//              significant bits and the dropped lo.lo term is ~2^-22
//              relative, so the result stays within fp32 round-off of a
//              full-fp32 product (the TPU's HIGHEST).  The port's default.
//   "high"     wgmma with bf16 operands and the same 3-pass split, _dot's
//              own "high" branch: hi + lo carries ~16 bits (~5e-6 of the
//              largest result from fp64).
//   "default"  one bf16 pass, x_hi.d_hi (_dot's "default" on a TPU).
// The contract is a template parameter (Tf32x3, Bf16<3>, Bf16<1> below).
// K1 and K2 share the column kernel (D @ X): tc::burgers_col in 3xTF32,
// tc::burgers_col_bf16 (clusters, multicast, a persistent ring) in the bf16
// contracts; K3 is the row kernel (X @ D^T, tc::burgers_row) in all three.
// All take the operator split and tiled once on the host side (`pack`) and
// differ in where the field tile's fragment elements sit and in their
// epilogue.  See the notes above the kernels.
//
// Two accumulators (the D1 rows and the D2 rows of the same output tile)
// are combined with nu_f and the matching conv element in the epilogue, so
// the 2F-field product never reaches device memory.  Ragged edges are
// masked: loads outside the array read 0, stores outside it are skipped.
//
// Entry points: plain C, launched on the caller's stream, returning
// cudaGetLastError(); "highest" without a suffix, "high" and "default" with
// theirs (burgers_x_high, burgers_x_default, ...).
//   burgers_x  K1  contracts axis 0: column form D @ X_f, X_f = (nx, ny*nz)
//   burgers_y  K2  contracts axis 1: column form D @ X_fi, X_fi = (ny, nz)
//   burgers_z  K3  contracts axis 2: row form X_f @ D^T, X_f = (nx*ny, nz)
// The same column and row kernels, with the epilogue a template policy,
// give the plain derivative products in "highest" alone (the note above
// the column form): deriv1_x/y/z (D1 @ X) and deriv12_x/y/z (D1 @ X and
// D2 @ X into two outputs).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTN = 4;          // outputs per 16-byte access

__device__ __forceinline__ void load4(float (&r)[4], const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
    return ((reinterpret_cast<uintptr_t>(a) |
             reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// kTN consecutive values v to o[0..cols); one 16-byte store when the whole
// group is in range.
__device__ __forceinline__ void store4(float* o, const float (&v)[kTN],
                                       int cols, bool vec) {
    if (vec && cols >= kTN) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        return;
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j)
        if (j < cols) o[j] = v[j];
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
// The tensor-core machinery both forms and all three contracts share.
//
// wgmma computes D (M x N, fp32 registers) += A (M x K) . B (K x N) with
// M = 64 field lines a warpgroup, N = kTA operator rows a, K = the
// contracted index.  B = the operator rows, which are K-major as they
// stand.  The operator is split once on the host side into `pack`: for each
// (row tile, K tile) the kTA x kKT tiles D1 hi, D1 lo, D2 hi, D2 lo (D1 and
// D2 alone for one pass), zero-padded, already in the 64-byte-swizzled
// core-matrix layout their wgmma descriptor names, so a stage's operator
// tiles are one contiguous copy of 8 KB a tile.  A K tile is 64 bytes of
// each operator row: 16 TF32 elements or 32 bf16 ones, two wgmma k-steps
// (k8 for TF32, k16 for bf16) of 32 bytes each.  A = the field tile comes
// from registers: each thread reads its fragment elements from a plain fp32
// tile in shared memory and splits them into hi + lo there (the operand
// type's rounding).  For TF32 thread (g, q) of warp w holds (m, k),
// (m + 8, k), (m, k + 4), (m + 8, k + 4) with m = 16 w + g, k = q; for
// bf16 the pairs (m, k..k+1), (m + 8, k..k+1), (m, k+8..k+9),
// (m + 8, k+8..k+9) with k = 2q, two to a register.  The two forms differ
// in the strides between those elements (the Tiles types below).
//
// wgmma could read a 16-bit A from shared memory, MN-major as well (the
// transpose bit that 32-bit operands lack), but the field is fp32 in
// device memory and has to be split first: reading the fragments into
// registers and splitting them there costs no second pass through shared
// memory, and keeps one ring and one set of loads for all three contracts.
//
// A block of two warpgroups owns 128 field lines (64 each) x 128 operator
// rows a and two fp32 accumulators per thread (D1 rows, D2 rows; 2 x 64
// registers), so one block fits an SM.  A ring of kStages shared-memory
// stages is filled by cp.async kStages - 2 K tiles ahead; each K tile is one
// commit group of 4 x passes wgmma (2 k-steps x {D1, D2} x {x_lo.d_hi,
// x_hi.d_lo, x_hi.d_hi}, or x_hi.d_hi alone), and the fragments of tile t+1
// are read and split while the products of tile t run (two register sets,
// wait_group 1).  The conv tile of the epilogue is asked into L2 a few K
// tiles before it is used, and the blocks are ordered so that those sharing
// a conv tile run side by side.
namespace tc {

constexpr int kTC = 128;             // field lines per block (2 warpgroups x 64)
constexpr int kTA = 128;             // operator rows per block (wgmma N)
constexpr int kThreads = 256;
constexpr int kOpSub = kTA * 16;     // floats in one operator tile (8 KB)
constexpr int kMaxSmemBytes = 232448;   // what one block may have on sm_90
constexpr int kOS = kTC + 4;         // column epilogue row stride, 4 mod 32
static_assert(kTA == 128 && kTC == 128, "prefetch_tile asks for 128 x 128");

// The contracts.  kKT: contraction depth per stage (64 bytes of operands);
// kRK: depth of a row-form field chunk (128-byte pieces of a field row);
// kXS, kRS: the row strides of the 3xTF32 column form's field tile and of
// the row form's chunks, set so that a warp's fragment reads spread over
// the banks (the bf16 column kernel reads a swizzled tile instead).
struct Tf32x3 {                      // "highest"
    static constexpr bool kBf16 = false;
    static constexpr int kPasses = 3;
    static constexpr int kKT = 16;
    static constexpr int kStages = 5;
    static constexpr int kRK = 32;   // 128-byte pieces of a field row
    static constexpr int kXS = kTC + 8;      // = 8 (mod 32): (k = q, m)
    static constexpr int kRS = kRK + 4;      // = 4 (mod 8)
};

template <int P>                     // "high" (P = 3), "default" (P = 1)
struct Bf16 {
    static constexpr bool kBf16 = true;
    static constexpr int kPasses = P;
    static constexpr int kKT = 32;
    // 4 stages of 4 operator tiles, 5 of 2: what fits beside the field tiles
    static constexpr int kStages = P == 3 ? 4 : 5;
    static constexpr int kRK = kKT;  // one K tile a chunk
    static constexpr int kRS = kRK + 8;      // = 8 (mod 32): 8-byte reads
};
using Bf16x3 = Bf16<3>;
using Bf16x1 = Bf16<1>;

// What follows from a contract: the ring's sizes in floats.
template <class C>
struct Layout : C {
    static constexpr int kParts = C::kPasses == 3 ? 4 : 2;  // tiles a stage
    static constexpr int kOpStage = kParts * kOpSub;
    static constexpr int kOpRing = C::kStages * kOpStage;
    static constexpr int kPrefetch = 128 / C::kKT;   // K tiles between asking
                                                     // for conv and using it
    // 3xTF32 column form: (k, c) field tiles, one a K tile, beside the
    // operator
    static constexpr int kXS = [] {
        if constexpr (C::kBf16) return 0; else return C::kXS;
    }();
    static constexpr int kXStage = C::kKT * kXS;
    static constexpr int kRing = kOpRing + C::kStages * kXStage;
    static constexpr int kSmemBytes = kRing * 4 + 1024;  // + alignment slack
    // row form: (r, k) field chunks kRK deep, one for kRT operator tiles
    static constexpr int kRT = C::kRK / C::kKT;      // K tiles a chunk serves
    static constexpr int kRG = kRT > 2 ? kRT : 2;    // an item's K tiles come
                                                     // in such groups
    static constexpr int kRChunk = kTC * C::kRS;
    // chunks alive at once: those of the kStages - 2 tiles ahead, and the
    // one being read
    static constexpr int kRChunks = (C::kStages - 2 + kRT - 1) / kRT + 1;
    static constexpr int kRowRing = kOpRing + kRChunks * kRChunk;
    static constexpr int kRowSmemBytes = kRowRing * 4 + 1024;

    static_assert(C::kKT * (C::kBf16 ? 2 : 4) == 64,
                  "the pack is laid out for the 64-byte swizzle");
    static_assert(C::kPasses == 3 || (C::kPasses == 1 && C::kBf16),
                  "3 passes, or one bf16 pass");
    static_assert(C::kBf16 || 2 * kTA * kOS <= kRing,
                  "epilogue tiles must fit in the ring");
    static_assert(C::kRK % C::kKT == 0 && kRG % kRT == 0 && kRG % 2 == 0,
                  "chunks hold whole K tiles, groups whole chunks and tile "
                  "pairs");
    static_assert(kXS % 4 == 0 && C::kRS % 4 == 0,
                  "16-byte copies into the field tiles");
    static_assert(C::kBf16 ? C::kRS % 32 == 8
                           : (kXS % 32 == 8 && C::kRS % 8 == 4),
                  "fragment reads must spread over the 32 banks");
    static_assert(kSmemBytes <= kMaxSmemBytes
                  && kRowSmemBytes <= kMaxSmemBytes,
                  "the rings must fit in one block's shared memory");
};

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
// The same for TF32 and bf16 tiles: the layout is one of bytes.
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

// (lo, hi) rounded to bf16, nearest even, in one register: lo in the low
// half (the lower k of a fragment pair), hi in the high half
__device__ __forceinline__ uint32_t to_bf16x2(float lo, float hi) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}

// the 64 fp32 accumulator operands of an m64n128 wgmma
#define WGMMA_ACC_64                                                  \
    "{%0, %1, %2, %3, %4, %5, %6, %7, "                               \
    "%8, %9, %10, %11, %12, %13, %14, %15, "                          \
    "%16, %17, %18, %19, %20, %21, %22, %23, "                        \
    "%24, %25, %26, %27, %28, %29, %30, %31, "                        \
    "%32, %33, %34, %35, %36, %37, %38, %39, "                        \
    "%40, %41, %42, %43, %44, %45, %46, %47, "                        \
    "%48, %49, %50, %51, %52, %53, %54, %55, "                        \
    "%56, %57, %58, %59, %60, %61, %62, %63}"
#define WGMMA_ACC_OUT(d)                                              \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                   \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),               \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),               \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),               \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),               \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),               \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),               \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),               \
    "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),               \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),               \
    "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),               \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),               \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

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
        WGMMA_ACC_64 ", "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : WGMMA_ACC_OUT(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16, registers) . B (16 x 128, bf16,
// shared memory through its descriptor, K-major: no transpose)
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        WGMMA_ACC_64 ", "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : WGMMA_ACC_OUT(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Start the copy of one stage's operator tiles: the kParts tiles of one
// (row tile, K tile) of the pack, contiguous there.  For a pair (kPair, the
// d1 entry points' StoreD1) the D1 tiles (hi, lo) of two row tiles: src's
// into parts 0 and 1, second's into parts 2 and 3, zeros where second is
// null (the pair's second row tile lies beyond n).
template <class C, bool kPair = false>
__device__ __forceinline__ void load_operator(float* ring, const float* src,
                                              const float* second, int stage,
                                              int tid) {
    using L = Layout<C>;
    constexpr int kCopies = L::kOpStage / 4 / kThreads;
    static_assert(!kPair || L::kParts == 4, "a pair fills 4 parts");
    const uint32_t op = smem_u32(ring + stage * L::kOpStage);
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
        const int e = (tid + i * kThreads) * 4;
        if (!kPair || i < kCopies / 2)
            cp_async16(op + e * 4, src + e, 16);
        else
            cp_async16(op + e * 4,
                       second ? second + (e - L::kOpStage / 2) : src,
                       second ? 16 : 0);
    }
}

// Ask for the part inside (rows, cols) of a 128 x 128 tile into L2, one
// request a 128-byte line.
__device__ __forceinline__ void prefetch_tile(const float* tile, size_t stride,
                                              int rows, int cols, int tid) {
    for (int i = tid; i < 128 * 4; i += kThreads) {
        const int r = i / 4, c = (i % 4) * 32;
        if (r < rows && c < cols) prefetch_l2(tile + r * stride + c);
    }
}

__device__ __forceinline__ void clear(float (&acc1)[64], float (&acc2)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) { acc1[i] = 0.f; acc2[i] = 0.f; }
}

// The K tiles of a column-form block: tile t is operator tile t of the
// block's row tile (of both row tiles of a pair) and the (kKT, kTC) field
// tile below it, in stage t % kStages.  Fragment element (m, k) sits at
// k * kXS + m.
template <class C, bool kPair = false>
struct ColTiles {
    using L = Layout<C>;
    static constexpr int kStepK = C::kXS, kStepM = 1;
    const float* pack_tiles;   // the row tile's operator tiles
    const float* xb;           // the batch's (n, ncol) slab
    int kt, n, ncol, c0;
    bool xvec;
    int tid, frag0;
    const float* second;       // a pair's second row tile's, or null

    // start the copies of tile t; zero beyond n and C, nothing beyond kt
    __device__ __forceinline__ void load(float* ring, int t) {
        if (t >= kt) return;
        const int s = t % L::kStages;
        load_operator<C, kPair>(
            ring, pack_tiles + (size_t)t * L::kOpStage,
            kPair && second ? second + (size_t)t * L::kOpStage : nullptr, s,
            tid);
        const uint32_t xs = smem_u32(ring + L::kOpRing + s * L::kXStage);
        const int k0 = t * C::kKT;
        if (xvec) {
#pragma unroll
            for (int i = 0; i < C::kKT * kTC / 4 / kThreads; ++i) {
                const int e = tid + i * kThreads;
                const int kk = e / (kTC / 4), cc = (e % (kTC / 4)) * 4;
                const int k = k0 + kk, c = c0 + cc;
                const bool ok = k < n && c < ncol;
                cp_async16(xs + (kk * C::kXS + cc) * 4,
                           ok ? xb + (size_t)k * ncol + c : xb, ok ? 16 : 0);
            }
        } else {
            for (int e = tid; e < C::kKT * kTC; e += kThreads) {
                const int kk = e / kTC, cc = e % kTC;
                const int k = k0 + kk, c = c0 + cc;
                const bool ok = k < n && c < ncol;
                cp_async4(xs + (kk * C::kXS + cc) * 4,
                          ok ? xb + (size_t)k * ncol + c : xb, ok ? 4 : 0);
            }
        }
    }

    // this thread's first fragment element of tile t
    __device__ __forceinline__ const float* frag(const float* ring,
                                                 int t) const {
        return ring + L::kOpRing + (t % L::kStages) * L::kXStage + frag0;
    }
};

// The K tiles of a row-form block, numbered through all its work items
// (one an operator row tile, or a pair of them): ring position t is K tile
// t % kt of item t / kt, in stage t % kStages.  kt is padded to whole
// groups of kRG, so the field chunks (kTC rows x kRK, one copied with every
// kRT-th tile) keep one numbering through the items; the padding tiles
// beyond kt_live hold nothing and are skipped.  Fragment element (m, k)
// sits at m * kRS + k.
// The copies are asked for in the order of t, each position once, so the
// item and K tile of the next one are counted along and not divided out.
template <class C, bool kPair = false>
struct RowTiles {
    using L = Layout<C>;
    static constexpr int kStepK = 1, kStepM = C::kRS;
    static constexpr int kTiles = kPair ? 2 : 1;    // row tiles an item
    const float* pack;         // the whole packed operator
    const float* xb;           // the block's first field row
    int kt, kt_live, items, n, rows;
    bool xvec;
    int tid, frag0;
    int item, tk;              // of the next position to be copied
    int at;                    // operator row tiles (read for a pair)

    // start the copies of position t; zero beyond n and the field's last
    // row, nothing for padding tiles and beyond the last item
    __device__ __forceinline__ void load(float* ring, int t) {
        if (item < items && tk < kt_live) {
            const float* src =
                pack + ((size_t)item * kTiles * kt_live + tk) * L::kOpStage;
            load_operator<C, kPair>(
                ring, src,
                kPair && kTiles * item + 1 < at
                    ? src + (size_t)kt_live * L::kOpStage : nullptr,
                t % L::kStages, tid);
            if (tk % L::kRT == 0) load_chunk(ring, t);
        }
        if (++tk == kt) { tk = 0; ++item; }
    }

    __device__ __forceinline__ void load_chunk(float* ring, int t) const {
        const uint32_t xs = smem_u32(
            ring + L::kOpRing + ((t / L::kRT) % L::kRChunks) * L::kRChunk);
        const int k0 = tk * C::kKT;
        if (xvec) {
#pragma unroll
            for (int i = 0; i < kTC * C::kRK / 4 / kThreads; ++i) {
                const int e = tid + i * kThreads;
                const int rr = e / (C::kRK / 4), kk = (e % (C::kRK / 4)) * 4;
                const int k = k0 + kk;
                const bool ok = rr < rows && k < n;
                cp_async16(xs + (rr * C::kRS + kk) * 4,
                           ok ? xb + (size_t)rr * n + k : xb, ok ? 16 : 0);
            }
        } else {
            for (int e = tid; e < kTC * C::kRK; e += kThreads) {
                const int rr = e / C::kRK, kk = e % C::kRK;
                const int k = k0 + kk;
                const bool ok = rr < rows && k < n;
                cp_async4(xs + (rr * C::kRS + kk) * 4,
                          ok ? xb + (size_t)rr * n + k : xb, ok ? 4 : 0);
            }
        }
    }

    __device__ __forceinline__ const float* frag(const float* ring,
                                                 int t) const {
        return ring + L::kOpRing + ((t / L::kRT) % L::kRChunks) * L::kRChunk
             + (t % L::kRT) * C::kKT + frag0;
    }
};

// One K tile: read this thread's A fragments from the field tile (element
// (m, k) of the fragment at xs[m * SM + k * SK]), split them, and start the
// tile's 4 x passes products against the operator stage at `op` as one
// commit group.  Operator tile i of the stage starts i * kOpSub floats in.
template <class C, int SK, int SM>
__device__ __forceinline__ void tile_products(
        const float* xs, uint32_t op, float (&acc1)[64], float (&acc2)[64],
        uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
    if constexpr (!C::kBf16) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            // a0 (m, k), a1 (m + 8, k), a2 (m, k + 4), a3 (m + 8, k + 4)
            const float v[4] = {xs[(j * 8) * SK], xs[(j * 8) * SK + 8 * SM],
                                xs[(j * 8 + 4) * SK],
                                xs[(j * 8 + 4) * SK + 8 * SM]};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                hi[j][i] = to_tf32(v[i]);
                lo[j][i] = to_tf32(v[i] - __uint_as_float(hi[j][i]));
            }
        }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
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
    } else {
        // the row form's chunks (the bf16 column form has its own reader,
        // col_bf16_products)
        static_assert(SK == 1, "bf16 pairs are adjacent in k");
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                // register i: (m + 8 (i % 2), k + 8 (i / 2)) and the k + 1
                // beside it, k = 16 j + 2 q
                const float* p = xs + (j * 16 + (i / 2) * 8) * SK
                               + (i % 2) * 8 * SM;
                const float2 w = *reinterpret_cast<const float2*>(p);
                const float v0 = w.x, v1 = w.y;
                hi[j][i] = to_bf16x2(v0, v1);
                if constexpr (C::kPasses == 3)
                    lo[j][i] = to_bf16x2(
                        v0 - __uint_as_float(hi[j][i] << 16),
                        v1 - __uint_as_float(hi[j][i] & 0xFFFF0000u));
            }
        }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            // a k-step of 16 is 32 bytes further along each 64-byte row
            if constexpr (C::kPasses == 3) {
                const uint64_t d1h = op_desc(op + j * 32);
                const uint64_t d1l = op_desc(op + kOpSub * 4 + j * 32);
                const uint64_t d2h = op_desc(op + 2 * kOpSub * 4 + j * 32);
                const uint64_t d2l = op_desc(op + 3 * kOpSub * 4 + j * 32);
                wgmma_m64n128k16_bf16(acc1, lo[j], d1h);   // small terms first
                wgmma_m64n128k16_bf16(acc2, lo[j], d2h);
                wgmma_m64n128k16_bf16(acc1, hi[j], d1l);
                wgmma_m64n128k16_bf16(acc2, hi[j], d2l);
                wgmma_m64n128k16_bf16(acc1, hi[j], d1h);
                wgmma_m64n128k16_bf16(acc2, hi[j], d2h);
            } else {
                wgmma_m64n128k16_bf16(acc1, hi[j], op_desc(op + j * 32));
                wgmma_m64n128k16_bf16(acc2, hi[j],
                                      op_desc(op + kOpSub * 4 + j * 32));
            }
        }
    }
    wgmma_commit();
}

// Iteration t of the ring: wait for K tile t, start the copies of tile
// t + kStages - 2 into the stage that tile t - 2 has left, start tile t's
// products (unless the tile is padding, `live` false), and wait until tile
// t - 1's are done.
template <class C, class Tiles>
__device__ __forceinline__ void ring_step(
        Tiles& tl, float* ring, int t, bool live, float (&acc1)[64],
        float (&acc2)[64], uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
    using L = Layout<C>;
    cp_async_wait<L::kStages - 3>();
    fence_async_shared();
    __syncthreads();
    tl.load(ring, t + L::kStages - 2);
    cp_async_commit();
    if (live)
        tile_products<C, Tiles::kStepK, Tiles::kStepM>(
            tl.frag(ring, t), smem_u32(ring + (t % L::kStages) * L::kOpStage),
            acc1, acc2, hi, lo);
    wgmma_wait<1>();
}

// The 1024-byte-aligned start of the dynamic shared memory (the swizzle
// works on address bits).
__device__ __forceinline__ float* aligned_ring(unsigned char* raw) {
    return reinterpret_cast<float*>(
        raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// ---------------------------------------------------------------------------
// The epilogues, a template policy of the 3xTF32 column kernel and of the
// row kernel:
//   Burgers   out = nu_f * D2 - conv * D1 (K1-K3, entry points burgers_*).
//   StoreD12  D1 into out and D2 into out2 (deriv12_*), two outputs.
//   StoreD1   the D1 product into out (deriv1_*).  A block's second
//             accumulator holds D1 of the next operator row tile in place
//             of D2 (kPair: each stage carries the D1 tiles of two row
//             tiles, load_operator), so that a d1 block runs as many
//             products on each field tile it reads as a Burgers block and
//             covers 2 kTA output rows.  The pack is the one of [D1; D2],
//             read by its D1 tiles only.
// The plain-store entry points replace no Pallas kernel: they stand for
// tlab_tpu's compressible einsums (HIGHEST, full fp32 off a TPU), which the
// port ran as cuBLAS fp32 products on the FMA units.  They are bound by
// operations as K1-K3 are: a point's D1 product is 2n flop and its [D1; D2]
// product 4n (512 to 2,048 at n = 256 and 512) against 8 bytes of field in
// and out, far above the fp32-FMA ridge of ~20 flop a byte, so they take
// the tensor cores in the same 3xTF32 contract (fp32 round-off of a full
// fp32 product), the same ring and the same packed operator, and write the
// accumulators straight out: no combine, no conv to read.
struct Burgers { static constexpr bool kCombine = true, kPair = false; };
struct StoreD12 { static constexpr bool kCombine = false, kPair = false; };
struct StoreD1 { static constexpr bool kCombine = false, kPair = true; };

// ---------------------------------------------------------------------------
// Column form (K1, K2) in the 3xTF32 contract; the bf16 contracts have their
// own design below (burgers_col_bf16).
//
// Batch b = f * G + g.  For each b the (n, C) output slab is
// out_b = nu_f * (D2 @ X_b) - conv_g .* (D1 @ X_b), with X_b, conv_g, out_b
// row-major (n, ncol) slabs.  K1: G = 1, ncol = ny*nz.  K2: G = nx,
// ncol = nz.  The plain-store epilogues write D1 @ X_b (and D2 @ X_b)
// instead, over B = F G slabs (F = 1 to col_body).
//
// wgmma takes 32-bit operands only K-major, and the field tile (k, c) has c
// contiguous, so a block computes the transposed tile
// out^T(c, a) = X^T(c, k) . D^T(k, a): the field lines are the columns c,
// and A = X^T is read through the fragment strides of ColTiles.  The
// epilogue stages both accumulators through the ring's memory, transposed
// back, and writes 16-byte rows of out, reading conv the same way.
//
// What holds it back now (H100, 512x256x256, 3xTF32): with the loads taken
// out the K loop runs at ~92% of the TF32 peak, but each block's prologue
// and epilogue (~0.7 ms over a launch) overlap nothing, since the 2 x 64
// accumulator registers allow one block an SM; the loads (~41 KB a K tile
// from L2) slow the loop by another ~20%.
template <class C, class E>
__device__ __forceinline__ void col_body(
        const float* __restrict__ pack, const float* __restrict__ x,
        const float* __restrict__ conv, const float* __restrict__ nu,
        float* __restrict__ out, float* __restrict__ out2, int n, int ncol,
        int G, int F, int a_tiles, int c_tiles)
{
    static_assert(!C::kBf16, "the bf16 contracts run burgers_col_bf16");
    using L = Layout<C>;
    constexpr int kTiles = E::kPair ? 2 : 1;    // operator row tiles a block
    extern __shared__ unsigned char smem_raw[];
    float* ring = aligned_ring(smem_raw);

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
    const int a0 = a_tile * kTiles * kTA;
    const int c0 = (rest % c_tiles) * kTC;
    const int g_slab = rest / c_tiles;
    const int b = f * G + g_slab;
    const size_t slab = (size_t)n * ncol;
    const int kt = (n + C::kKT - 1) / C::kKT;
    // this thread's rows of A: m = 16 * warp + g (+ 8); its first column k
    // is q for TF32, 2q for bf16
    const int m = warp * 16 + g;
    const int kq = C::kBf16 ? 2 * q : q;
    const float* tiles = pack + (size_t)a_tile * kTiles * kt * L::kOpStage;
    ColTiles<C, E::kPair> tl{
        tiles, x + (size_t)b * slab, kt, n, ncol, c0,
        (ncol % 4) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0, tid,
        kq * C::kXS + m,
        E::kPair && a0 + kTA < n ? tiles + (size_t)kt * L::kOpStage
                                 : nullptr};

    const float* cg =
        E::kCombine ? conv + (size_t)g_slab * slab : nullptr;

    float acc1[64], acc2[64];
    clear(acc1, acc2);
    uint32_t hi_a[2][4], lo_a[2][4];
    uint32_t hi_b[2][4], lo_b[2][4];

#pragma unroll
    for (int t = 0; t < L::kStages - 2; ++t) {
        tl.load(ring, t);
        cp_async_commit();
    }
    // The epilogue's conv tile is asked into L2 (128-byte lines) kPrefetch
    // K tiles before the end, so that its trip from device memory overlaps
    // the products and the field tiles streaming through L2 meanwhile do
    // not push it out again.  The F blocks that share the tile run side by
    // side, and the first of them asks.
    const int ask_at = E::kCombine && f == 0
        ? (kt > L::kPrefetch ? (kt - L::kPrefetch) & ~1 : 0) : -1;
    // two tiles per trip, so that each has its own fragment registers
    for (int t = 0; t < kt; t += 2) {
        if (t == ask_at)
            prefetch_tile(cg + (size_t)a0 * ncol + c0, ncol, n - a0,
                          ncol - c0, tid);
        ring_step<C>(tl, ring, t, true, acc1, acc2, hi_a, lo_a);
        if (t + 1 < kt)
            ring_step<C>(tl, ring, t + 1, true, acc1, acc2, hi_b, lo_b);
    }
    wgmma_wait<0>();
    cp_async_wait<0>();
    __syncthreads();

    // the accumulators hold out^T: d[4j + 2h + e] is (c = m + 8h,
    // a = 8j + 2q + e).  Store them as (a, c) tiles, then write by rows.
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

    float* ob = out + (size_t)b * slab;
    if constexpr (E::kCombine) {
        const float nu_f = nu[f];
        const bool vec = (ncol % 4) == 0 && aligned16(cg, ob);
        for (int i = tid; i < kTA * (kTC / 4); i += kThreads) {
            const int aa = i / (kTC / 4), cc = (i % (kTC / 4)) * 4;
            const int a = a0 + aa, c = c0 + cc;
            if (a >= n || c >= ncol) continue;
            float d1[kTN], d2[kTN];
            load4(d1, &s1[aa * kOS + cc]);
            load4(d2, &s2[aa * kOS + cc]);
            const size_t o = (size_t)a * ncol + c;
            combine_store(ob + o, cg + o, d1, d2, nu_f, ncol - c, vec);
        }
    } else {
        // the second accumulator: D2 of the same rows into out2, or D1 of
        // the pair's second row tile, kTA rows further down out
        float* ob2 = E::kPair ? ob + (size_t)kTA * ncol
                              : out2 + (size_t)b * slab;
        const bool vec = (ncol % 4) == 0 && aligned16(ob, ob2);
        const int rows2 = E::kPair ? n - a0 - kTA : n - a0;
        for (int i = tid; i < kTA * (kTC / 4); i += kThreads) {
            const int aa = i / (kTC / 4), cc = (i % (kTC / 4)) * 4;
            const int c = c0 + cc;
            if (c >= ncol) continue;
            const size_t o = (size_t)(a0 + aa) * ncol + c;
            float v[kTN];
            if (aa < n - a0) {
                load4(v, &s1[aa * kOS + cc]);
                store4(ob + o, v, ncol - c, vec);
            }
            if (aa < rows2) {
                load4(v, &s2[aa * kOS + cc]);
                store4(ob2 + o, v, ncol - c, vec);
            }
        }
    }
}

template <class C>
__global__ void __launch_bounds__(kThreads, 1)
burgers_col(const float* __restrict__ pack, const float* __restrict__ x,
            const float* __restrict__ conv, const float* __restrict__ nu,
            float* __restrict__ out, int n, int ncol, int G, int F,
            int a_tiles, int c_tiles)
{
    col_body<C, Burgers>(pack, x, conv, nu, out, nullptr, n, ncol, G, F,
                         a_tiles, c_tiles);
}

// The plain products (StoreD1, StoreD12) of B (n, ncol) slabs, 3xTF32;
// `units` operator row tiles (StoreD12) or pairs of them (StoreD1).
template <class E>
__global__ void __launch_bounds__(kThreads, 1)
deriv_col(const float* __restrict__ pack, const float* __restrict__ x,
          float* __restrict__ d1, float* __restrict__ d2, int n, int ncol,
          int B, int units, int c_tiles)
{
    col_body<Tf32x3, E>(pack, x, nullptr, nullptr, d1, d2, n, ncol, B, 1,
                        units, c_tiles);
}

// ---------------------------------------------------------------------------
// Column form (K1, K2) in the bf16 contracts: "high" (3 bf16 passes) and
// "default" (one), the TPU kernels _kern_x and _kern_y
// (tlab_tpu/ops/pallas_burgers.py:62, :71) at prec_name "high" and
// "default" (_dot, :38-58).
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3 at 700 W, 512x256x256,
// F = 4, tools/burgers_variants.py; PERF.md section 6).  The bf16
// instances of the 3xTF32 design that this kernel replaced (a block of 128
// lines x 128 operator rows, one an SM, every thread copying its share by
// cp.async) read, for K1 "default": 1.122 ms, 1.108
// without its products, 0.809 without its K loop's copies, 1.038 with the
// field's copies alone and 0.817 with the operator's alone; K1 "high"
// 1.724, 1.369 without products or without copies.  So the field's
// per-thread copies set the pace, the operator's cost nothing by
// themselves, and with no copies at all each block's exposed first copies
// and epilogue (0.81 ms against 0.28 of products) weighed as much again.
//
// What the design does about it.  A cluster of cc x ca blocks shares both
// streams from L2: the ca blocks on one field tile (its operator row tiles,
// ca up to 4) and the cc blocks on one operator row tile (cc = 8 / ca line
// tiles, fields and slabs included: the operator is the same for all).
// K1 at 512x256x256 runs 2 x 4, K2 4 x 2 (2 x 2 and 4 x 2 measured within
// 3% of them, 8 x 1 3-6% slower).
//   - The operator stage is contiguous in the pack (pack_operator), so each
//     of the cc blocks copies 1 / cc of it with one 1-D bulk copy
//     (cp.async.bulk, no tensor map) multicast into all cc blocks.
//   - A field tile (32 rows x 128 lines of fp32) is 4 boxes of 32 lines of
//     a 3-D tensor map over the (F G, n, ncol) slabs, in the 128-byte
//     swizzle; each of the ca blocks copies 4 / ca of them multicast into
//     all ca.  (One bulk copy a 512-byte row was measured 3x slower: the
//     copies' count, not their bytes, set its pace.)  The swizzle spreads
//     a warp's fragment reads over the 32 banks (their addresses are XORed
//     to match), and the copy fills rows beyond n and lines beyond ncol
//     with zeros.  A tensor map needs 16-byte strides and bases (ncol % 4
//     == 0; x, conv, out aligned); other shapes take the cp.async path of
//     the kernel (the producer warp's 32 lanes write the same swizzled
//     layout, zero-filling; ca = 1).  "high" also asks each box into L2
//     kAhead K tiles before its copy; "default" keeps pace better without.
//   - Arrival goes to each stage's full mbarrier (expect_tx of the bytes
//     that land in the block: always a whole operator stage and, on the
//     bulk path, 4 whole boxes); a consumer warpgroup done with a stage
//     arrives on the empty mbarrier of every block that writes into it (its
//     op group and its field group), and a producer waits for its own empty
//     barrier before it writes into any of them.  Every block writes the
//     same bytes into every block of its groups in every round (a padded
//     slot copies row tile 0's operator, and out-of-range boxes are zeros),
//     so no consumer can arrive a round early.
//   - The grid is persistent: as many clusters as fit walk the (line group,
//     row group) tiles, and one producer warp keeps kStages K tiles in
//     flight across tile ends.  The two consumer warpgroups (64 lines each)
//     read their fragments, split them (hi, lo on the registers, as before)
//     and run wgmma with 240 registers a thread (setmaxnreg; the producer
//     warpgroup keeps 24, and its waits carry no counter: one cost the
//     loops 13%).  The epilogue has a 64 KB tile of its own: a storer
//     thread copies each tile's conv into it during the K loop, the
//     consumers combine their accumulators with nu_f and conv in place,
//     and the storer writes it to out by the tensor map while the
//     consumers run on into the next tile.  (Combining from registers with
//     conv read from device memory made ptxas serialize the wgmma for
//     want of registers, and cost more than the tile's stages.)  Padded
//     cluster slots (n / 128 or the line tiles not a multiple of the
//     extents) keep the barrier and copy protocol and skip products and
//     stores.
// L2 -> shared memory at 512x256x256, F = 4: K1 1.5 GiB ("default", 4 GiB
// before) and 2.5 GiB ("high", 6), K2 0.75 and 1.0 GiB (2 and 3).
//
// What holds it back now (same card and reading): without the epilogue's
// combine and stores K1 "default" takes 0.658 ms and K2 0.410, against
// 0.278 and 0.139 of products: 5 stages of 32 KB are ~0.66 us a K tile, the
// time it takes a stage to come back round the cluster; "high" (3 stages
// of 48 KB beside the epilogue tile) K1 1.141 against its bound 0.834.
// The epilogue costs the rest: 0.13-0.19 ms a launch.
template <class C>
struct ColRing {
    static_assert(C::kBf16, "the bf16 contracts");
    static constexpr int kThreads = 384;     // 2 consumer warpgroups + 1
    static constexpr int kParts = C::kPasses == 3 ? 4 : 2;
    static constexpr int kOpBytes = kParts * kOpSub * 4;  // a stage's operator
    static constexpr int kBox = 32;          // lines a box: 128 swizzled bytes
    static constexpr int kXBytes = C::kKT * kTC * 4;      // and field tile
    static constexpr int kEBytes = kTA * kTC * 4;  // the epilogue's tile
    static constexpr int kStages = C::kPasses == 3 ? 3 : 5;
    // K tiles a field box is asked into L2 before its copy (none in
    // "default", whose producer keeps pace better without)
    static constexpr int kAhead = C::kPasses == 3 ? 8 : 0;
    static constexpr int kSmemBytes =
        kStages * (kOpBytes + kXBytes + 16) + kEBytes + 16 + 1024;
    static_assert(kSmemBytes <= kMaxSmemBytes, "the ring must fit");
    static_assert(kSmemBytes <= kMaxSmemBytes, "the ring must fit");
    static_assert(C::kKT == 32 && kTC % kBox == 0,
                  "a box is 32 rows of 128 bytes");
};

struct ColArgs {
    // (bulk path) the field and out, (F G, n, ncol), and conv, (G, n, ncol)
    CUtensorMap xmap, cmap, omap;
    const float* pack;
    const float* x;
    const float* conv;
    const float* nu;
    float* out;
    int n, ncol, G, F;
    int at, ct, lines;       // operator row tiles, line tiles a slab, in all
    int cc, ca;              // the cluster's extents (line tiles, row tiles)
    int bulk;                // field, conv and out by the tensor maps
};

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release;\n"
                 "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

// wait for the phase of `parity` to complete
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n"
                     ".reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n"
                     "}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// arrive on the barrier at the same offset in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote) : "r"(bar), "r"(rank));
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n"
                 :: "r"(remote) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// this thread's cp.async copies so far arrive on `bar` when they land
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned) from src into dst of every
// block in `mask`, each counted on its barrier at offset `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint16_t mask) {
    if ((mask & (mask - 1)) == 0)
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                     "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                     :: "r"(dst), "l"(src), "r"(bytes), "r"(bar)
                     : "memory");
    else
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                     "complete_tx::bytes.multicast::cluster [%0], [%1], %2, "
                     "[%3], %4;\n"
                     :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask)
                     : "memory");
}

// the box of the tensor map at (c, k, b) into dst of every block in `mask`
__device__ __forceinline__ void box_copy(uint32_t dst, const CUtensorMap* map,
                                         int c, int k, int b, uint32_t bar,
                                         uint16_t mask) {
    const uint64_t desc = reinterpret_cast<uint64_t>(map);
    if ((mask & (mask - 1)) == 0)
        asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global."
                     "mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
                     "[%5];\n"
                     :: "r"(dst), "l"(desc), "r"(c), "r"(k), "r"(b), "r"(bar)
                     : "memory");
    else
        asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global."
                     "mbarrier::complete_tx::bytes.multicast::cluster [%0], "
                     "[%1, {%2, %3, %4}], [%5], %6;\n"
                     :: "r"(dst), "l"(desc), "r"(c), "r"(k), "r"(b), "r"(bar),
                        "h"(mask)
                     : "memory");
}

// ask for the box of the tensor map at (c, k, b) into L2
__device__ __forceinline__ void box_prefetch(const CUtensorMap* map, int c,
                                             int k, int b) {
    asm volatile("cp.async.bulk.prefetch.tensor.3d.L2.global.tile "
                 "[%0, {%1, %2, %3}];\n"
                 :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(k),
                    "r"(b) : "memory");
}

// the epilogue tile's 4 boxes of 32 lines x 128 rows at (c0, a0, b) into
// out, as one bulk group; zero beyond the tensor's edges is not written
__device__ __forceinline__ void store_boxes(const CUtensorMap* map,
                                            uint32_t src, int c0, int a0,
                                            int b) {
    const uint64_t desc = reinterpret_cast<uint64_t>(map);
#pragma unroll
    for (int j = 0; j < 4; ++j)
        asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
                     "[%0, {%1, %2, %3}], [%4];\n"
                     :: "l"(desc), "r"(c0 + 32 * j), "r"(a0), "r"(b),
                        "r"(src + j * 128 * 128) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Byte offset of field element (k, line c) in a stage: box c / 32, rows of
// 128 bytes, the 16-byte chunk c % 32 / 4 XORed with k % 8 (the 128-byte
// swizzle of the tensor map; the stages are 1024-byte aligned).
__device__ __forceinline__ int field_offset(int k, int c) {
    return (c / 32) * (32 * 128) + k * 128 + ((((c % 32) >> 2) ^ (k & 7)) << 4)
         + (c & 3) * 4;
}

// Byte offset of element (operator row a, line c) in the epilogue tile:
// boxes of 32 lines x 128 rows, in the same swizzle
__device__ __forceinline__ int epi_offset(int a, int c) {
    return (c / 32) * (128 * 128) + a * 128
         + ((((c % 32) >> 2) ^ (a & 7)) << 4) + (c & 3) * 4;
}

// One output tile of the persistent walk: cluster tile T of a block at
// (l, aa) of its cluster.
struct ColTile {
    int a0, c0, f, g, b;
    bool op_live, x_live;

    __device__ __forceinline__ ColTile(const ColArgs& p, int T, int l,
                                       int aa) {
        const int groups = (p.at + p.ca - 1) / p.ca;
        const int lg = T / groups;
        const int A = (T - lg * groups) * p.ca + aa;
        const int Lt = lg * p.cc + l;
        op_live = A < p.at;
        x_live = Lt < p.lines;
        // line tiles: fields fastest (the F tiles that share a conv tile
        // sit in one cluster), then the slab's column tiles, then slabs; a
        // padded slot copies row tile 0's operator and lines past the last
        const int L = x_live ? Lt : p.lines;
        f = L % p.F;
        const int rest = L / p.F;
        c0 = (rest % p.ct) * kTC;
        g = rest / p.ct;
        b = f * p.G + g;
        a0 = (op_live ? A : 0) * kTA;
    }
};

// One K tile of the bf16 column form: this thread's A fragments from the
// field stage at xs (byte offsets off[h][e] of its elements (m + 8h,
// k + e), k = 2q, in the first 8 rows; 8 rows further is 1024 bytes,
// the swizzle's period), split, and the tile's products against the
// operator stage at `op` as one commit group.
template <class C>
__device__ __forceinline__ void col_bf16_products(
        const unsigned char* xs, const int (&off)[2][2], uint32_t op,
        float (&acc1)[64], float (&acc2)[64], uint32_t (&hi)[2][4],
        uint32_t (&lo)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // register i: (m + 8 (i % 2), k + 8 (i / 2)) and the k + 1
            // beside it, k = 16 j + 2 q
            const unsigned char* p = xs + (j * 2 + i / 2) * 1024;
            const float v0 = *reinterpret_cast<const float*>(
                p + off[i % 2][0]);
            const float v1 = *reinterpret_cast<const float*>(
                p + off[i % 2][1]);
            hi[j][i] = to_bf16x2(v0, v1);
            if constexpr (C::kPasses == 3)
                lo[j][i] = to_bf16x2(
                    v0 - __uint_as_float(hi[j][i] << 16),
                    v1 - __uint_as_float(hi[j][i] & 0xFFFF0000u));
        }
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        // a k-step of 16 is 32 bytes further along each 64-byte row
        if constexpr (C::kPasses == 3) {
            const uint64_t d1h = op_desc(op + j * 32);
            const uint64_t d1l = op_desc(op + kOpSub * 4 + j * 32);
            const uint64_t d2h = op_desc(op + 2 * kOpSub * 4 + j * 32);
            const uint64_t d2l = op_desc(op + 3 * kOpSub * 4 + j * 32);
            wgmma_m64n128k16_bf16(acc1, lo[j], d1h);     // small terms first
            wgmma_m64n128k16_bf16(acc2, lo[j], d2h);
            wgmma_m64n128k16_bf16(acc1, hi[j], d1l);
            wgmma_m64n128k16_bf16(acc2, hi[j], d2l);
            wgmma_m64n128k16_bf16(acc1, hi[j], d1h);
            wgmma_m64n128k16_bf16(acc2, hi[j], d2h);
        } else {
            wgmma_m64n128k16_bf16(acc1, hi[j], op_desc(op + j * 32));
            wgmma_m64n128k16_bf16(acc2, hi[j],
                                  op_desc(op + kOpSub * 4 + j * 32));
        }
    }
    wgmma_commit();
}

// The ring as one block sees it: the stages' operator tiles, field tiles,
// full and empty barriers, and the position (stage, phase) of the next K
// tile.
template <class C>
struct ColRingState {
    using R = ColRing<C>;
    static constexpr uint32_t kX0 = R::kStages * R::kOpBytes;
    static constexpr uint32_t kEpi = kX0 + R::kStages * R::kXBytes;
    static constexpr uint32_t kFull = kEpi + R::kEBytes;
    static constexpr uint32_t kEmpty = kFull + R::kStages * 8;
    static constexpr uint32_t kEpiFull = kEmpty + R::kStages * 8;
    static constexpr uint32_t kEpiDone = kEpiFull + 8;
    uint32_t op0;                // the ring's start; the rest follows it
    int stage = 0;
    uint32_t phase = 0;

    __device__ __forceinline__ explicit ColRingState(uint32_t base)
        : op0(base) {}

    __device__ __forceinline__ uint32_t full0() const { return op0 + kFull; }
    __device__ __forceinline__ uint32_t empty0() const {
        return op0 + kEmpty;
    }
    __device__ __forceinline__ uint32_t epi() const { return op0 + kEpi; }
    __device__ __forceinline__ uint32_t epi_full() const {
        return op0 + kEpiFull;
    }
    __device__ __forceinline__ uint32_t epi_done() const {
        return op0 + kEpiDone;
    }
    __device__ __forceinline__ uint32_t full() const {
        return full0() + 8 * stage;
    }
    __device__ __forceinline__ uint32_t empty() const {
        return empty0() + 8 * stage;
    }
    __device__ __forceinline__ uint32_t op() const {
        return op0 + stage * R::kOpBytes;
    }
    __device__ __forceinline__ uint32_t field() const {
        return op0 + kX0 + stage * R::kXBytes;
    }
    __device__ __forceinline__ void advance() {
        if (++stage == R::kStages) { stage = 0; phase ^= 1; }
    }
};

template <class C>
__global__ void __launch_bounds__(ColRing<C>::kThreads, 1)
burgers_col_bf16(const __grid_constant__ ColArgs p)
{
    using R = ColRing<C>;
    extern __shared__ unsigned char smem_raw[];
    float* ring = aligned_ring(smem_raw);
    ColRingState<C> rs(smem_u32(ring));

    const int tid = threadIdx.x;
    // the warpgroup, uniform over each warp as setmaxnreg needs it
    const int wg = __shfl_sync(0xFFFFFFFFu, tid / 128, 0);
    const int rank = static_cast<int>(cluster_rank());
    const int l = rank % p.cc, aa = rank / p.cc;
    const int cs = p.cc * p.ca;
    const int cluster = blockIdx.x / cs, clusters = gridDim.x / cs;
    const int kt = (p.n + C::kKT - 1) / C::kKT;
    const int tiles = (p.lines + p.cc - 1) / p.cc
                    * ((p.at + p.ca - 1) / p.ca);
    const size_t slab = (size_t)p.n * p.ncol;

    if (tid == 0) {
        for (int s = 0; s < R::kStages; ++s) {
            mbar_init(rs.full0() + 8 * s, p.bulk ? 1 : 1 + 32);
            // one arrival a consumer warpgroup of each writing block
            mbar_init(rs.empty0() + 8 * s, 2 * (p.cc + p.ca - 1));
        }
        mbar_init(rs.epi_full(), 1);
        mbar_init(rs.epi_done(), 256);      // every consumer thread
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_sync();

    if (wg == 2) {
        // producer warpgroup: its first warp issues the copies (lane 0 the
        // bulk ones, all 32 lanes those of the cp.async path); the
        // registers go to the consumers
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        const int lane = tid % 32;
        if (tid < 2 * 128 + 32 && (lane == 0 || !p.bulk)) {
            // the blocks on this block's operator row tile, on its field
            // tile
            const uint16_t op_mask = static_cast<uint16_t>(
                ((1 << p.cc) - 1) << (aa * p.cc));
            uint16_t x_mask = 0;
            for (int i = 0; i < p.ca; ++i) x_mask |= 1 << (i * p.cc + l);
            const unsigned char* pack =
                reinterpret_cast<const unsigned char*>(p.pack);
            const int share = R::kOpBytes / p.cc;
            const int boxes = kTC / R::kBox / p.ca;    // this block's
            const uint32_t bytes = R::kOpBytes + (p.bulk ? R::kXBytes : 0);
            for (int T = cluster; T < tiles; T += clusters) {
                const ColTile tl(p, T, l, aa);
                // the tile after this one, for the boxes asked into L2
                const ColTile tn(p, T + clusters, l, aa);
                const bool more = T + clusters < tiles;
                const unsigned char* ops =
                    pack + (size_t)(tl.a0 / kTA) * kt * R::kOpBytes
                    + l * share;
                for (int t = 0; t < kt; ++t, rs.advance()) {
                    mbar_wait(rs.empty(), rs.phase ^ 1);
                    if (lane == 0) {
                        mbar_expect(rs.full(), bytes);
                        bulk_copy(rs.op() + l * share,
                                  ops + (size_t)t * R::kOpBytes, share,
                                  rs.full(), op_mask);
                    }
                    if (p.bulk) {
                        for (int j = aa * boxes; j < (aa + 1) * boxes; ++j)
                            box_copy(rs.field() + j * R::kBox * 128, &p.xmap,
                                     tl.c0 + j * R::kBox, t * C::kKT, tl.b,
                                     rs.full(), x_mask);
                        // the boxes kAhead K tiles on, from device memory
                        // into L2, so that their copy waits on L2 only
                        const int u = t + R::kAhead;
                        if (R::kAhead > 0 && (u < kt || more)) {
                            const ColTile& tu = u < kt ? tl : tn;
                            const int ku = (u < kt ? u : u - kt) * C::kKT;
                            for (int j = aa * boxes; j < (aa + 1) * boxes;
                                 ++j)
                                box_prefetch(&p.xmap, tu.c0 + j * R::kBox, ku,
                                             tu.b);
                        }
                    } else {
                        // the (kKT, kTC) tile in the swizzled layout, zero
                        // beyond n, ncol and the last line tile
                        const float* xb = p.x + (size_t)tl.b * slab + tl.c0;
                        const int rows = min(C::kKT, p.n - t * C::kKT);
                        const int cols = min(kTC, p.ncol - tl.c0);
                        const uint32_t xs = rs.field();
#pragma unroll 4
                        for (int e = lane; e < C::kKT * kTC; e += 32) {
                            const int kk = e / kTC, cc = e % kTC;
                            const bool ok = tl.x_live && kk < rows
                                            && cc < cols;
                            cp_async4(xs + field_offset(kk, cc),
                                      ok ? xb + (size_t)(t * C::kKT + kk)
                                                    * p.ncol + cc
                                         : p.x,
                                      ok ? 4 : 0);
                        }
                        cp_async_arrive(rs.full());
                    }
                }
            }
        }
        if (tid == 2 * 128 + 32 && p.bulk) {
            // the storer (the second warp's lane 0): each tile's conv into
            // the epilogue tile, and the tile's results from it into out
            // once the consumers have written them; the next conv once the
            // store has read them
            uint32_t done_phase = 0;
            for (int T = cluster; T < tiles; T += clusters) {
                const ColTile tl(p, T, l, aa);
                mbar_expect(rs.epi_full(), R::kEBytes);
                for (int j = 0; j < 4; ++j)
                    box_copy(rs.epi() + j * 128 * 128, &p.cmap,
                             tl.c0 + j * R::kBox, tl.a0, tl.g, rs.epi_full(),
                             0);
                mbar_wait(rs.epi_done(), done_phase);
                done_phase ^= 1;
                if (tl.op_live && tl.x_live)
                    store_boxes(&p.omap, rs.epi(), tl.c0, tl.a0, tl.b);
                asm volatile("cp.async.bulk.wait_group.read 0;\n"
                             ::: "memory");
            }
            asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        }
        // peers may still arrive on this block's barriers
        __syncwarp();
        cluster_sync();
    } else {
        // consumer warpgroups: 64 lines each
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int lane = tid % 32, warp = tid / 32;
        const int g = lane / 4, q = lane % 4;
        const int m = warp * 16 + g;
        const bool releases = tid % 128 == 0;
        // this thread's fragment elements (m + 8h, 2q + e) in a stage, and
        // its accumulator elements (a = 2q + e, c = m + 8h) in the
        // epilogue tile (8 rows further is 1024 bytes in both)
        int off[2][2], eoff[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                off[h][e] = field_offset(2 * q + e, m + 8 * h);
                eoff[h][e] = epi_offset(2 * q + e, m + 8 * h);
            }
        const unsigned char* xring =
            reinterpret_cast<const unsigned char*>(ring)
            + R::kStages * R::kOpBytes;
        float* epi = reinterpret_cast<float*>(
            reinterpret_cast<unsigned char*>(ring) + (rs.epi() - rs.op0));
        float acc1[64], acc2[64];
        uint32_t hi_a[2][4], lo_a[2][4];
        uint32_t hi_b[2][4], lo_b[2][4];
        int held = -1;               // the stage of the tile in flight
        uint32_t epi_phase = 0;
        // On the cp.async path the tile's conv comes into the epilogue tile
        // by every consumer thread's copies, asked for after the tile's
        // first K tile (the last tile's stores are done), zero beyond the
        // edges; on the bulk path the storer asks for it.
        auto ask_conv = [&](const ColTile& tl) {
            if (p.bulk) return;
            const float* cb = p.conv + (size_t)tl.g * slab
                            + (size_t)tl.a0 * p.ncol + tl.c0;
            const int rows = p.n - tl.a0;
            const int cols = min(kTC, p.ncol - tl.c0);
            for (int e = tid; e < kTA * kTC; e += 256) {
                const int a = e / kTC, c = e % kTC;
                const bool ok = tl.x_live && a < rows && c < cols;
                cp_async4(rs.epi() + epi_offset(a, c),
                          ok ? cb + (size_t)a * p.ncol + c : p.x, ok ? 4 : 0);
            }
            cp_async_commit();
        };

        // release stage s: one arrival on the empty barrier of every block
        // that writes into this one (its op group and its field group)
        auto release = [&](int s) {
            if (!releases) return;
            const uint32_t bar = rs.empty0() + 8 * s;
            for (int i = 0; i < p.cc; ++i) mbar_arrive_at(bar, aa * p.cc + i);
            for (int i = 0; i < p.ca; ++i)
                if (i != aa) mbar_arrive_at(bar, i * p.cc + l);
        };
        // K tile t: wait for it, start its products (a live tile), then
        // wait for the previous tile's and release its stage
        auto step = [&](bool live, uint32_t (&hi)[2][4],
                        uint32_t (&lo)[2][4]) {
            mbar_wait(rs.full(), rs.phase);
            if (live)
                col_bf16_products<C>(xring + rs.stage * R::kXBytes, off,
                                     rs.op(), acc1, acc2, hi, lo);
            wgmma_wait<1>();
            if (held >= 0) release(held);
            held = rs.stage;
            rs.advance();
        };

        for (int T = cluster; T < tiles; T += clusters) {
            const ColTile tl(p, T, l, aa);
            const bool live = tl.op_live && tl.x_live;
            clear(acc1, acc2);
            for (int t = 0; t < kt; t += 2) {
                step(live, hi_a, lo_a);
                if (t == 0) ask_conv(tl);
                if (t + 1 < kt) step(live, hi_b, lo_b);
            }
            wgmma_wait<0>();
            release(held);
            held = -1;

            // the accumulators hold out^T: d[4j + 2h + e] is (c = m + 8h,
            // a = 8j + 2q + e); combined with conv in the epilogue tile,
            // in place
            if (p.bulk) {
                mbar_wait(rs.epi_full(), epi_phase);
                epi_phase ^= 1;
            } else {
                cp_async_wait<0>();
                consumers_sync();
            }
            if (live) {
                const float nu_f = p.nu[tl.f];
#pragma unroll
                for (int j = 0; j < 16; ++j)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int i = 4 * j + 2 * h + e;
                            float* v = reinterpret_cast<float*>(
                                reinterpret_cast<unsigned char*>(epi)
                                + eoff[h][e] + j * 1024);
                            *v = nu_f * acc2[i] - *v * acc1[i];
                        }
            }
            if (p.bulk) {
                // the storer stores the tile
                fence_async_shared();
                mbar_arrive(rs.epi_done());
            } else {
                // rows of the tile into out, masked
                consumers_sync();
                if (live) {
                    float* ob = p.out + (size_t)tl.b * slab
                              + (size_t)tl.a0 * p.ncol + tl.c0;
                    const int rows = p.n - tl.a0;
                    const int cols = min(kTC, p.ncol - tl.c0);
                    for (int e = tid; e < kTA * kTC; e += 256) {
                        const int a = e / kTC, c = e % kTC;
                        if (a < rows && c < cols)
                            ob[(size_t)a * p.ncol + c] = *reinterpret_cast<
                                const float*>(reinterpret_cast<const unsigned
                                char*>(epi) + epi_offset(a, c));
                    }
                }
                consumers_sync();
            }
        }
        cluster_sync();
    }
}

// ---------------------------------------------------------------------------
// Row form (K3).
//
// For each field f the (P, n) output slab (P = nx * ny rows) is
// out_f = nu_f * (X_f @ D2^T) - conv .* (X_f @ D1^T), all row-major (P, n).
//
// Here both operands are K-major as they lie in memory: the field lines are
// the rows r, A = X is read through the fragment strides of RowTiles from
// plain (r, k) chunks whose row stride (kRS) spreads a warp's
// fragment reads over the 32 banks.  A chunk is kRK deep, so that a field
// row comes from L2 in 128-byte pieces, and serves kRT operator tiles.
//
// A block owns (f, 128 rows of P) and walks over the operator's row tiles
// as its work items.  The accumulators hold out itself: d[4j + 2h + e] is
// (r = m + 8h, a = 8j + 2q + e), two consecutive a a thread, so the
// epilogue combines on registers and writes 8-byte pieces, 32 bytes a row
// and warp, and needs none of the ring.  The ring therefore runs through
// the items without a stop: when an item's last products are started, the
// copies of the next item's first kStages - 2 tiles are already on their
// way, and they land while the epilogue reads conv and stores.  A row tile
// never straddles two fields, so nu_f is one scalar a block; the F blocks
// that share a conv tile run side by side, and the first asks for it.
// The plain-store epilogues write the accumulators as they stand
// (row_store) and read no conv, so there the F nx ny rows of all fields
// are one (P, n) slab (F = 1 to row_body).
//
// What holds it back now (H100, 512x256x256, 3xTF32, 1.51 ms a launch
// against a bound of 0.83 ms): the copies from L2 (without them 1.26 ms)
// and, as in the column form, each block's first copies and last
// epilogue, which overlap nothing.  The K loop is sensitive to integer work ahead of the
// copies: with the item and K tile of a position divided out of t (two
// divisions a tile) a launch took 1.93 ms.  A 16- or 64-deep chunk, the
// next item's copies only after the epilogue, and an epilogue staged
// through the ring for 16-byte rows were all measured slower.

// out = nu_f * acc2 - conv * acc1 for this thread's part of a (rows, cols)
// tile, straight from the accumulators; cv and ob point at the tile's first
// element.  conv is read in batches of 8 pieces ahead of their use.
__device__ __forceinline__ void row_epilogue(
        const float (&acc1)[64], const float (&acc2)[64],
        const float* __restrict__ cv, float* __restrict__ ob, float nu_f,
        size_t n, int rows, int cols, int m, int q, bool vec) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = m + 8 * h;
        if (r >= rows) continue;
        const float* cr = cv + r * n + 2 * q;
        float* orow = ob + r * n + 2 * q;
        const int left = cols - 2 * q;      // columns from this thread's first
        if (vec) {
#pragma unroll
            for (int jb = 0; jb < 16; jb += 8) {
                float2 c[8];
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    c[j] = 8 * (jb + j) < left
                        ? *reinterpret_cast<const float2*>(cr + 8 * (jb + j))
                        : make_float2(0.f, 0.f);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int i = 4 * (jb + j) + 2 * h;
                    float2 v;
                    v.x = nu_f * acc2[i] - c[j].x * acc1[i];
                    v.y = nu_f * acc2[i + 1] - c[j].y * acc1[i + 1];
                    if (8 * (jb + j) < left)
                        *reinterpret_cast<float2*>(orow + 8 * (jb + j)) = v;
                }
            }
        } else {
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    if (8 * j + e < left)
                        orow[8 * j + e] = nu_f * acc2[4 * j + 2 * h + e]
                            - cr[8 * j + e] * acc1[4 * j + 2 * h + e];
        }
    }
}

// acc to this thread's part of a (rows, cols) tile at ob, straight from
// the accumulator, in 8-byte pieces where vec.
__device__ __forceinline__ void row_store(
        const float (&acc)[64], float* __restrict__ ob, size_t n, int rows,
        int cols, int m, int q, bool vec) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = m + 8 * h;
        if (r >= rows) continue;
        float* orow = ob + r * n + 2 * q;
        const int left = cols - 2 * q;      // columns from this thread's first
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int i = 4 * j + 2 * h;
            if (vec) {
                if (8 * j < left)
                    *reinterpret_cast<float2*>(orow + 8 * j) =
                        make_float2(acc[i], acc[i + 1]);
            } else {
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    if (8 * j + e < left) orow[8 * j + e] = acc[i + e];
            }
        }
    }
}

template <class C, class E>
__device__ __forceinline__ void row_body(
        const float* __restrict__ pack, const float* __restrict__ x,
        const float* __restrict__ conv, const float* __restrict__ nu,
        float* __restrict__ out, float* __restrict__ out2, int n, int P,
        int F, int items)
{
    using L = Layout<C>;
    constexpr int kTiles = E::kPair ? 2 : 1;    // operator row tiles an item
    extern __shared__ unsigned char smem_raw[];
    float* ring = aligned_ring(smem_raw);

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, q = lane % 4;
    // fields vary fastest: the F blocks that share a conv tile run side by
    // side
    const int f = blockIdx.x % F;
    const int p0 = (blockIdx.x / F) * kTC;
    const size_t row0 = (size_t)f * P + p0;
    const int kt_live = (n + C::kKT - 1) / C::kKT;
    const int kt = (kt_live + L::kRG - 1) / L::kRG * L::kRG;
    // this thread's rows of A: m = 16 * warp + g (+ 8); its first column k
    // is q for TF32, 2q for bf16
    const int m = warp * 16 + g;
    const int kq = C::kBf16 ? 2 * q : q;
    RowTiles<C, E::kPair> tl{
        pack, x + row0 * n, kt, kt_live, items, n, P - p0,
        (n % 4) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0, tid,
        m * C::kRS + kq, 0, 0, (n + kTA - 1) / kTA};

    const float* cv = E::kCombine ? conv + (size_t)p0 * n : nullptr;
    float* ob = out + row0 * n;
    const float nu_f = E::kCombine ? nu[f] : 0.f;
    // the second accumulator's output: D2 of the same columns into out2, or
    // D1 of the pair's second row tile, kTA columns further along out
    const int off2 = E::kPair ? kTA : 0;
    float* ob2 = E::kCombine || E::kPair ? ob : out2 + row0 * n;
    // 8-byte pieces: every (r, a) with a even is then 8-byte aligned
    const bool vec = (n % 2) == 0 &&
        ((reinterpret_cast<uintptr_t>(E::kCombine ? conv : ob2) |
          reinterpret_cast<uintptr_t>(out)) & 7) == 0;

    float acc1[64], acc2[64];
    clear(acc1, acc2);
    uint32_t hi_a[2][4], lo_a[2][4];
    uint32_t hi_b[2][4], lo_b[2][4];

#pragma unroll
    for (int t = 0; t < L::kStages - 2; ++t) {
        tl.load(ring, t);
        cp_async_commit();
    }
    // as in the column form: the first of the F blocks sharing the item's
    // conv tile asks for it kPrefetch K tiles before the item's epilogue
    const int ask_at = E::kCombine && f == 0
        ? (kt_live > L::kPrefetch ? (kt_live - L::kPrefetch) & ~1 : 0)
        : -1;
    // two tiles per trip, so that each has its own fragment registers (kt
    // is even); t runs on through the items
    int t = 0;
    for (int a0 = 0; a0 < n; a0 += kTiles * kTA) {
        for (int tk = 0; tk < kt; tk += 2, t += 2) {
            if (tk == ask_at)
                prefetch_tile(cv + a0, n, tl.rows, n - a0, tid);
            ring_step<C>(tl, ring, t, tk < kt_live, acc1, acc2, hi_a, lo_a);
            ring_step<C>(tl, ring, t + 1, tk + 1 < kt_live, acc1, acc2, hi_b,
                         lo_b);
        }
        wgmma_wait<0>();
        if constexpr (E::kCombine) {
            row_epilogue(acc1, acc2, cv + a0, ob + a0, nu_f, n, tl.rows,
                         n - a0, m, q, vec);
        } else {
            row_store(acc1, ob + a0, n, tl.rows, n - a0, m, q, vec);
            row_store(acc2, ob2 + a0 + off2, n, tl.rows, n - a0 - off2, m, q,
                      vec);
        }
        clear(acc1, acc2);
    }
}

template <class C>
__global__ void __launch_bounds__(kThreads, 1)
burgers_row(const float* __restrict__ pack, const float* __restrict__ x,
            const float* __restrict__ conv, const float* __restrict__ nu,
            float* __restrict__ out, int n, int P, int F, int a_tiles)
{
    row_body<C, Burgers>(pack, x, conv, nu, out, nullptr, n, P, F, a_tiles);
}

// The plain products (StoreD1, StoreD12) of P rows of n, 3xTF32; `units`
// operator row tiles (StoreD12) or pairs of them (StoreD1) a block walks.
template <class E>
__global__ void __launch_bounds__(kThreads, 1)
deriv_row(const float* __restrict__ pack, const float* __restrict__ x,
          float* __restrict__ d1, float* __restrict__ d2, int n, int P,
          int units)
{
    row_body<Tf32x3, E>(pack, x, nullptr, nullptr, d1, d2, n, P, 1, units);
}

}  // namespace tc

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// `blocks` blocks of `kernel` with `smem` bytes of shared memory on
// `stream`
template <class... Params, class... Args>
int launch(void (*kernel)(Params...), int smem, long long blocks,
           void* stream, Args... args)
{
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<static_cast<unsigned>(blocks), tc::kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

// F * G batches of (n, ncol) slabs through the column kernel
template <class C>
int launch_col(const float* pack, const float* x, const float* conv,
               const float* nu, float* out, int n, int ncol, int G, int F,
               void* stream)
{
    const int at = ceil_div(n, tc::kTA), ct = ceil_div(ncol, tc::kTC);
    return launch(tc::burgers_col<C>, tc::Layout<C>::kSmemBytes,
                  (long long)at * ct * F * G, stream, pack, x, conv, nu, out,
                  n, ncol, G, F, at, ct);
}

// operator row tiles, or pairs of them, a plain-store epilogue walks
template <class E>
int deriv_units(int n)
{
    return ceil_div(n, (E::kPair ? 2 : 1) * tc::kTA);
}

// D1 (StoreD1), or D1 and D2 (StoreD12), of B (n, ncol) slabs through the
// column kernel
template <class E>
int launch_deriv_col(const float* pack, const float* x, float* d1, float* d2,
                     int n, int ncol, int B, void* stream)
{
    const int units = deriv_units<E>(n), ct = ceil_div(ncol, tc::kTC);
    return launch(tc::deriv_col<E>, tc::Layout<tc::Tf32x3>::kSmemBytes,
                  (long long)units * ct * B, stream, pack, x, d1, d2, n, ncol,
                  B, units, ct);
}

// The cluster of the bf16 column kernel: ca operator row tiles that share
// a field tile (a power of 2 up to 4 and up to at; 1 on the cp.async path,
// which copies each block's field itself), times cc line tiles that share
// the operator stages (8 blocks in all, no more line tiles than there are).
// ops/burgers.py::column_schedule is the same choice, held by the tests.
inline void col_cluster(int at, int lines, bool bulk, int* cc, int* ca)
{
    int a = 1;
    while (bulk && a * 2 <= at && a * 2 <= 4) a *= 2;
    int c = 8 / a;
    while (c > 1 && c / 2 >= lines) c /= 2;
    *cc = c;
    *ca = a;
}

// The 3-D tensor map of B fp32 (n, ncol) slabs at x, in boxes of 32 lines
// x `rows` rows, 128-byte swizzled, zero beyond its edges; the driver's
// encoder is found through the runtime, so nothing links libcuda.
int slab_map(CUtensorMap* map, const float* x, int n, int ncol, int B,
             int rows)
{
    using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
    static Encode encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (found != cudaDriverEntryPointSuccess || fn == nullptr)
            return static_cast<int>(cudaErrorNotSupported);
        encode = reinterpret_cast<Encode>(fn);
    }
    const cuuint64_t dim[3] = {static_cast<cuuint64_t>(ncol),
                               static_cast<cuuint64_t>(n),
                               static_cast<cuuint64_t>(B)};
    const cuuint64_t stride[2] = {static_cast<cuuint64_t>(ncol) * 4,
                                  static_cast<cuuint64_t>(n) * ncol * 4};
    const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(rows), 1};
    const cuuint32_t step[3] = {1, 1, 1};
    const CUresult res = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x), dim,
        stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// F * G batches of (n, ncol) slabs through the bf16 column kernel: a
// persistent grid of as many clusters as fit on the card, at most one a
// cluster tile
template <class C>
int launch_col_bf16(const float* pack, const float* x, const float* conv,
                    const float* nu, float* out, int n, int ncol, int G,
                    int F, void* stream)
{
    using R = tc::ColRing<C>;
    auto kernel = tc::burgers_col_bf16<C>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::ColArgs a{};
    a.pack = pack;
    a.x = x;
    a.conv = conv;
    a.nu = nu;
    a.out = out;
    a.n = n;
    a.ncol = ncol;
    a.G = G;
    a.F = F;
    a.at = ceil_div(n, tc::kTA);
    a.ct = ceil_div(ncol, tc::kTC);
    const long long lines = (long long)F * G * a.ct;
    if (lines > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    a.lines = static_cast<int>(lines);
    a.bulk = ncol % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    a.bulk = a.bulk && ((reinterpret_cast<uintptr_t>(conv)
                         | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (a.bulk) {
        int e = slab_map(&a.xmap, x, n, ncol, F * G, 32);
        if (e == 0) e = slab_map(&a.cmap, conv, n, ncol, G, tc::kTA);
        if (e == 0) e = slab_map(&a.omap, out, n, ncol, F * G, tc::kTA);
        if (e != 0) return e;
    }
    col_cluster(a.at, a.lines, a.bulk, &a.cc, &a.ca);
    const int cs = a.cc * a.ca;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs);
    cfg.blockDim = dim3(R::kThreads);
    cfg.dynamicSmemBytes = R::kSmemBytes;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // clusters that fit at once, asked once a process for each extent
    static int active[9] = {};
    if (active[cs] == 0) {
        err = cudaOccupancyMaxActiveClusters(&active[cs], kernel, &cfg);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (active[cs] == 0)
            return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const long long tiles = (lines + a.cc - 1) / a.cc
                          * ((a.at + a.ca - 1) / a.ca);
    cfg.gridDim = dim3(static_cast<unsigned>(
        (tiles < active[cs] ? tiles : active[cs]) * cs));
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// the column form of a contract: its own design for the bf16 ones
template <class C>
int launch_column(const float* pack, const float* x, const float* conv,
                  const float* nu, float* out, int n, int ncol, int G, int F,
                  void* stream)
{
    if constexpr (C::kBf16)
        return launch_col_bf16<C>(pack, x, conv, nu, out, n, ncol, G, F,
                                  stream);
    else
        return launch_col<C>(pack, x, conv, nu, out, n, ncol, G, F, stream);
}

// F fields of (P, n) slabs through the row kernel
template <class C>
int launch_row(const float* pack, const float* x, const float* conv,
               const float* nu, float* out, int n, int P, int F, void* stream)
{
    return launch(tc::burgers_row<C>, tc::Layout<C>::kRowSmemBytes,
                  (long long)ceil_div(P, tc::kTC) * F, stream, pack, x, conv,
                  nu, out, n, P, F, ceil_div(n, tc::kTA));
}

// D1 (StoreD1), or D1 and D2 (StoreD12), of P rows of n through the row
// kernel
template <class E>
int launch_deriv_row(const float* pack, const float* x, float* d1, float* d2,
                     int n, int P, void* stream)
{
    return launch(tc::deriv_row<E>, tc::Layout<tc::Tf32x3>::kRowSmemBytes,
                  (long long)ceil_div(P, tc::kTC), stream, pack, x, d1, d2, n,
                  P, deriv_units<E>(n));
}

}  // namespace

// Tile sizes of the split operator that the entry points take as `pack`
// (see tlab_tpu_torch/ops/burgers.py::pack_operator): rows and K-tile depth
// in elements, TF32 for "highest", bf16 for "high" and "default".
extern "C" void burgers_pack_tiles(int* rows, int* depth)
{
    *rows = tc::kTA;
    *depth = tc::Tf32x3::kKT;
}

extern "C" void burgers_pack_tiles_bf16(int* rows, int* depth)
{
    *rows = tc::kTA;
    *depth = tc::Bf16x3::kKT;
}

// The bf16 column kernel's launch for F * G slabs of (n, ncol): the
// cluster's extents and the cluster tiles the grid walks, {cc, ca, tiles}
// (bulk: the field rows start on 16 bytes), as ops/burgers.py's
// column_schedule computes them.
extern "C" void burgers_col_schedule(int n, int ncol, int G, int F, int bulk,
                                     int* out)
{
    const int at = ceil_div(n, tc::kTA);
    const long long lines = (long long)F * G * ceil_div(ncol, tc::kTC);
    col_cluster(at, static_cast<int>(lines), bulk != 0, &out[0], &out[1]);
    out[2] = static_cast<int>((lines + out[0] - 1) / out[0]
                              * ((at + out[1] - 1) / out[1]));
}

// burgers_x, burgers_y, burgers_z with `suffix`, in contract C
#define BURGERS_ENTRY_POINTS(suffix, C)                                      \
    extern "C" int burgers_x##suffix(                                        \
            const float* pack, const float* x, const float* conv,            \
            const float* nu, float* out, int F, int nx, int ny, int nz,      \
            void* stream)                                                    \
    {                                                                        \
        return launch_column<C>(pack, x, conv, nu, out, nx, ny * nz, 1, F,   \
                                stream);                                     \
    }                                                                        \
    extern "C" int burgers_y##suffix(                                        \
            const float* pack, const float* x, const float* conv,            \
            const float* nu, float* out, int F, int nx, int ny, int nz,      \
            void* stream)                                                    \
    {                                                                        \
        return launch_column<C>(pack, x, conv, nu, out, ny, nz, nx, F,       \
                                stream);                                     \
    }                                                                        \
    extern "C" int burgers_z##suffix(                                        \
            const float* pack, const float* x, const float* conv,            \
            const float* nu, float* out, int F, int nx, int ny, int nz,      \
            void* stream)                                                    \
    {                                                                        \
        return launch_row<C>(pack, x, conv, nu, out, nz, nx * ny, F,         \
                             stream);                                        \
    }

BURGERS_ENTRY_POINTS(, tc::Tf32x3)            // "highest"
BURGERS_ENTRY_POINTS(_high, tc::Bf16x3)       // "high"
BURGERS_ENTRY_POINTS(_default, tc::Bf16x1)    // "default"

// deriv1_x/y/z: D1 @ x along axis 0, 1 or 2 of the stacked fields x
// (F, nx, ny, nz) into d1 (d2 unused); deriv12_x/y/z: D1 @ x into d1 and
// D2 @ x into d2.  3xTF32; pack is burgers_x/y/z's, the [D1; D2] operator
// packed for "highest" (deriv1 reads its D1 tiles).  x is contracted as
// K1 (B = F slabs of (nx, ny nz)), K2 (F nx slabs of (ny, nz)) or K3
// (F nx ny rows of nz).
#define DERIV_ENTRY_POINTS(name, E)                                          \
    extern "C" int name##_x(const float* pack, const float* x, float* d1,    \
                            float* d2, int F, int nx, int ny, int nz,        \
                            void* stream)                                    \
    {                                                                        \
        return launch_deriv_col<E>(pack, x, d1, d2, nx, ny * nz, F, stream); \
    }                                                                        \
    extern "C" int name##_y(const float* pack, const float* x, float* d1,    \
                            float* d2, int F, int nx, int ny, int nz,        \
                            void* stream)                                    \
    {                                                                        \
        return launch_deriv_col<E>(pack, x, d1, d2, ny, nz, F * nx, stream); \
    }                                                                        \
    extern "C" int name##_z(const float* pack, const float* x, float* d1,    \
                            float* d2, int F, int nx, int ny, int nz,        \
                            void* stream)                                    \
    {                                                                        \
        return launch_deriv_row<E>(pack, x, d1, d2, nz, F * nx * ny,         \
                                   stream);                                  \
    }

DERIV_ENTRY_POINTS(deriv1, tc::StoreD1)
DERIV_ENTRY_POINTS(deriv12, tc::StoreD12)
