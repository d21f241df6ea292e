// The pointwise algebra of the compressible internal-energy right-hand side
// (tlab_tpu_torch/dycore/compressible.py, rhs_compressible_internal at
// constant viscosity without a mixture) in three fused fp32 kernels around
// its derivative products; fp32 in and out.
//
// Replaces no TPU kernel: tlab_tpu leaves this algebra to XLA, which fuses
// it; the port ran it as PyTorch elementwise passes (~150 a substep).  What
// bounds it on an H100 is bytes: a few operations a point against 4 bytes
// of every field read or written, far below the fp32 ridge of ~20
// flop/byte.  So each kernel reads each input once and writes each output
// once, with 16-byte accesses where every pointer and the point count
// allow (4 points a thread), else one point a thread.  The arithmetic is
// plain fp32 (IEEE division, no fast-math): it differs from the PyTorch
// algebra only in the order of its sums and in FMA contraction.
//
// A substep runs, for each direction d with more than one point, in turn:
//   comp_flux_<d>      the state (rho, rho u, rho v, rho w, rho e, rho s)
//                      -> the direction's fluxes [rho u u_d + p delta_1d,
//                      rho v u_d + p delta_2d, rho w u_d + p delta_3d,
//                      rho e u_d, rho s u_d]; for the first direction also
//                      the stack [u, v, w, T] and s that the [D1;D2]
//                      products take
//   (the direction's d1 and [D1;D2] products, ops/burgers.py)
//   comp_assemble_<d>  the direction's derivatives -> the tendencies
//                      (written by the first direction, added to by the
//                      others): -d(rho u_d), -d(flux) + mu d2 u_i,
//                      -d(rho e u_d) + cond d2 T, -d(rho s u_d) + D (rho d2
//                      s + d rho d s); the velocity gradients along d kept
//                      for the last direction, which adds Phi - p div u to
//                      the energy and writes div u
// and then, after the d1 products of div u,
//   comp_final         (mu / 3) d_i(div u) into the momentum tendencies.
//
// Entry points: plain C, launched on the caller's stream, returning
// cudaGetLastError().  Pointers come in host arrays of kSlots (a null slot
// is a field that is not there), the coefficients in a host array of
// kSlots floats (kMu, kCond, kCT, kCP, then each scalar's diffusivity);
// both are copied into kernel parameters, so a launch reads nothing back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxScalars = 8;
constexpr int kSlots = 16;

// coefficient slots: mu, the conduction coefficient, T = (rho e / rho) cT,
// p = rho T cP, the scalars' diffusivities from kDiff on (comp_final: kMu
// holds mu / 3)
enum { kMu = 0, kCond = 1, kCT = 2, kCP = 3, kDiff = 4 };

struct In { const float* p[kSlots]; };
struct Out { float* p[kSlots]; };
struct Coef { float c[kSlots]; };

template <int V>
__device__ __forceinline__ void ld(float (&r)[V], const float* p,
                                   long long i) {
    if constexpr (V == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p + i);
        r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
    } else {
        r[0] = p[i];
    }
}

template <int V>
__device__ __forceinline__ void st(float* p, long long i,
                                   const float (&r)[V]) {
    if constexpr (V == 4) {
        *reinterpret_cast<float4*>(p + i) = make_float4(r[0], r[1], r[2],
                                                        r[3]);
    } else {
        p[i] = r[0];
    }
}

// a tendency's value so far: 0 for the first direction
template <int V>
__device__ __forceinline__ void ld_h(float (&r)[V], const float* p,
                                     long long i, bool first) {
    if (first) {
#pragma unroll
        for (int l = 0; l < V; ++l) r[l] = 0.0f;
    } else {
        ld<V>(r, p, i);
    }
}

// in: 0 rho, 1 rho u, 2 rho v, 3 rho w, 4 rho e, 5 rho s (ns fields)
// out: 0 the fluxes (4 + ns fields), 1 [u, v, w, T] or null, 2 s (ns
// fields) or null
template <int D, int V>
__global__ void __launch_bounds__(kThreads)
flux_kernel(In in, Out out, long long n, int ns, Coef k)
{
    const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
    if (i >= n) return;
    float r[V], m[3][V], e[V], u[3][V], T[V], p[V];
    ld<V>(r, in.p[0], i);
#pragma unroll
    for (int c = 0; c < 3; ++c) ld<V>(m[c], in.p[1 + c], i);
    ld<V>(e, in.p[4], i);
#pragma unroll
    for (int l = 0; l < V; ++l) {
#pragma unroll
        for (int c = 0; c < 3; ++c) u[c][l] = m[c][l] / r[l];
        T[l] = e[l] / r[l] * k.c[kCT];
        p[l] = r[l] * T[l] * k.c[kCP];
    }
    float* f = out.p[0];
    float o[V];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int l = 0; l < V; ++l)
            o[l] = c == D ? m[c][l] * u[D][l] + p[l] : m[c][l] * u[D][l];
        st<V>(f + c * n, i, o);
    }
#pragma unroll
    for (int l = 0; l < V; ++l) o[l] = e[l] * u[D][l];
    st<V>(f + 3 * n, i, o);
    float* s = out.p[2];
#pragma unroll
    for (int q = 0; q < kMaxScalars; ++q) {
        if (q >= ns) break;
        float a[V];
        ld<V>(a, in.p[5] + q * n, i);
#pragma unroll
        for (int l = 0; l < V; ++l) o[l] = a[l] * u[D][l];
        st<V>(f + (4 + q) * n, i, o);
        if (s != nullptr) {
#pragma unroll
            for (int l = 0; l < V; ++l) o[l] = a[l] / r[l];
            st<V>(s + q * n, i, o);
        }
    }
    float* prim = out.p[1];
    if (prim != nullptr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) st<V>(prim + c * n, i, u[c]);
        st<V>(prim + 3 * n, i, T);
    }
}

// in: 0 d(rho u_D), 1-3 d of the momentum fluxes, 4 d of the energy flux,
// 5 d of the scalar fluxes (ns), 6 d1 [u, v, w, T] (4), 7 d2 [u, v, w, T]
// (4), 8 d1 s (ns), 9 d2 s (ns), 10 d rho (ns > 0), 11 rho, 12 rho e, 13-15
// the velocity gradients [d u, d v, d w] along x, y, z (read by the last
// direction; null where a direction has none)
// out: 0 the tendencies (5 + ns), 1 this direction's velocity gradients
// (3; all but the last direction), 2 div u (the last)
template <int D, int V>
__global__ void __launch_bounds__(kThreads)
assemble_kernel(In in, Out out, long long n, int ns, int first, int last,
                Coef k)
{
    const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
    if (i >= n) return;
    const float mu = k.c[kMu];
    float* h = out.p[0];
    float a[V], b[V], t[V];

    ld_h<V>(t, h, i, first);                      // continuity
    ld<V>(a, in.p[0], i);
#pragma unroll
    for (int l = 0; l < V; ++l) t[l] -= a[l];
    st<V>(h, i, t);

#pragma unroll
    for (int c = 0; c < 3; ++c) {                 // momentum
        ld_h<V>(t, h + (1 + c) * n, i, first);
        ld<V>(a, in.p[1 + c], i);
        ld<V>(b, in.p[7] + c * n, i);
#pragma unroll
        for (int l = 0; l < V; ++l) t[l] = t[l] - a[l] + mu * b[l];
        st<V>(h + (1 + c) * n, i, t);
    }

    float he[V];                                  // energy
    ld_h<V>(he, h + 4 * n, i, first);
    ld<V>(a, in.p[4], i);
    ld<V>(b, in.p[7] + 3 * n, i);
#pragma unroll
    for (int l = 0; l < V; ++l) he[l] = he[l] - a[l] + k.c[kCond] * b[l];

    if (ns > 0) {                                 // scalars
        float r[V], dr[V], s1[V];
        ld<V>(r, in.p[11], i);
        ld<V>(dr, in.p[10], i);
#pragma unroll
        for (int q = 0; q < kMaxScalars; ++q) {
            if (q >= ns) break;
            float* hs = h + (5 + q) * n;
            ld_h<V>(t, hs, i, first);
            ld<V>(a, in.p[5] + q * n, i);
            ld<V>(s1, in.p[8] + q * n, i);
            ld<V>(b, in.p[9] + q * n, i);
#pragma unroll
            for (int l = 0; l < V; ++l)
                t[l] = t[l] - a[l]
                    + k.c[kDiff + q] * (r[l] * b[l] + dr[l] * s1[l]);
            st<V>(hs, i, t);
        }
    }

    // g[d][c]: the gradient of velocity component c along direction d
    float g[3][3][V];
#pragma unroll
    for (int c = 0; c < 3; ++c) ld<V>(g[D][c], in.p[6] + c * n, i);
    if (!last) {
#pragma unroll
        for (int c = 0; c < 3; ++c) st<V>(out.p[1] + c * n, i, g[D][c]);
        st<V>(h + 4 * n, i, he);
        return;
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        if (d == D) continue;
        const float* gd = in.p[13 + d];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            if (gd != nullptr) {
                ld<V>(g[d][c], gd + c * n, i);
            } else {
#pragma unroll
                for (int l = 0; l < V; ++l) g[d][c][l] = 0.0f;
            }
        }
    }
    float r[V], e[V], divu[V];
    ld<V>(r, in.p[11], i);
    ld<V>(e, in.p[12], i);
    const float lam = -2.0f / 3.0f;
#pragma unroll
    for (int l = 0; l < V; ++l) {
        const float ux = g[0][0][l], vy = g[1][1][l], wz = g[2][2][l];
        const float sxy = g[1][0][l] + g[0][1][l];   // uy + vx
        const float sxz = g[2][0][l] + g[0][2][l];   // uz + wx
        const float syz = g[2][1][l] + g[1][2][l];   // vz + wy
        divu[l] = ux + vy + wz;
        const float txx = mu * (2.0f * ux + lam * divu[l]);
        const float tyy = mu * (2.0f * vy + lam * divu[l]);
        const float tzz = mu * (2.0f * wz + lam * divu[l]);
        const float phi = txx * ux + tyy * vy + tzz * wz + mu * sxy * sxy
            + mu * sxz * sxz + mu * syz * syz;
        const float T = e[l] / r[l] * k.c[kCT];
        const float p = r[l] * T * k.c[kCP];
        he[l] = he[l] - p * divu[l] + phi;
    }
    st<V>(h + 4 * n, i, he);
    st<V>(out.p[2], i, divu);
}

// in: 0-2 d(div u) along x, y, z (null where a direction has none)
// out: 0 the tendencies; k.c[kMu] = mu / 3
template <int V>
__global__ void __launch_bounds__(kThreads)
final_kernel(In in, Out out, long long n, Coef k)
{
    const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
    if (i >= n) return;
    float t[V], a[V];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        if (in.p[c] == nullptr) continue;
        float* hm = out.p[0] + (1 + c) * n;
        ld<V>(t, hm, i);
        ld<V>(a, in.p[c], i);
#pragma unroll
        for (int l = 0; l < V; ++l) t[l] += k.c[kMu] * a[l];
        st<V>(hm, i, t);
    }
}

struct Launch {
    In in;
    Out out;
    Coef coef;
    long long n;
    bool vec4;
    cudaStream_t stream;

    Launch(const void* const* pin, void* const* pout, long long n_,
           const float* pcoef, void* s) : n(n_), stream((cudaStream_t)s) {
        // 16-byte accesses where the point count and every pointer allow
        vec4 = n % 4 == 0;
        for (int j = 0; j < kSlots; ++j) {
            in.p[j] = static_cast<const float*>(pin[j]);
            out.p[j] = static_cast<float*>(pout[j]);
            coef.c[j] = pcoef[j];
            vec4 = vec4 && (uintptr_t)pin[j] % 16 == 0
                && (uintptr_t)pout[j] % 16 == 0;
        }
    }

    unsigned blocks() const {
        const long long per = (long long)kThreads * (vec4 ? 4 : 1);
        return static_cast<unsigned>((n + per - 1) / per);
    }
};

template <int D>
int launch_flux(const void* const* in, void* const* out, long long n,
                int ns, const float* coef, void* stream)
{
    if (ns < 0 || ns > kMaxScalars) return cudaErrorInvalidValue;
    if (n <= 0) return cudaSuccess;
    Launch L(in, out, n, coef, stream);
    if (L.vec4)
        flux_kernel<D, 4><<<L.blocks(), kThreads, 0, L.stream>>>(
            L.in, L.out, n, ns, L.coef);
    else
        flux_kernel<D, 1><<<L.blocks(), kThreads, 0, L.stream>>>(
            L.in, L.out, n, ns, L.coef);
    return cudaGetLastError();
}

template <int D>
int launch_assemble(const void* const* in, void* const* out, long long n,
                    int ns, int first, int last, const float* coef,
                    void* stream)
{
    if (ns < 0 || ns > kMaxScalars) return cudaErrorInvalidValue;
    if (n <= 0) return cudaSuccess;
    Launch L(in, out, n, coef, stream);
    if (L.vec4)
        assemble_kernel<D, 4><<<L.blocks(), kThreads, 0, L.stream>>>(
            L.in, L.out, n, ns, first, last, L.coef);
    else
        assemble_kernel<D, 1><<<L.blocks(), kThreads, 0, L.stream>>>(
            L.in, L.out, n, ns, first, last, L.coef);
    return cudaGetLastError();
}

}  // namespace

extern "C" int comp_rhs_max_scalars() { return kMaxScalars; }

#define COMP_ENTRY_POINTS(d, D)                                              \
    extern "C" int comp_flux_##d(const void* const* in, void* const* out,   \
                                 long long n, int ns, const float* coef,     \
                                 void* stream)                               \
    {                                                                        \
        return launch_flux<D>(in, out, n, ns, coef, stream);                 \
    }                                                                        \
    extern "C" int comp_assemble_##d(const void* const* in,                  \
                                     void* const* out, long long n, int ns,  \
                                     int first, int last, const float* coef, \
                                     void* stream)                           \
    {                                                                        \
        return launch_assemble<D>(in, out, n, ns, first, last, coef,         \
                                  stream);                                   \
    }

COMP_ENTRY_POINTS(x, 0)
COMP_ENTRY_POINTS(y, 1)
COMP_ENTRY_POINTS(z, 2)

extern "C" int comp_final(const void* const* in, void* const* out,
                          long long n, const float* coef, void* stream)
{
    if (n <= 0) return cudaSuccess;
    Launch L(in, out, n, coef, stream);
    if (L.vec4)
        final_kernel<4><<<L.blocks(), kThreads, 0, L.stream>>>(
            L.in, L.out, n, L.coef);
    else
        final_kernel<1><<<L.blocks(), kThreads, 0, L.stream>>>(
            L.in, L.out, n, L.coef);
    return cudaGetLastError();
}
