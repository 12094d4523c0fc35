// Degeneracy projector of the registration's 6x6 normal matrix, for Hopper
// (sm_90a): one kernel, projector_kernel.
//
// Replaces no TPU kernel: the reference computes this with jnp.linalg.eigh
// (lmsf_slam_tpu/ops/registration.py::_degeneracy_projector), which XLA
// lowers to its own eigensolver. On the card torch.linalg.eigh goes to
// cuSOLVER and checks its info flag on the host: two device-to-host copies
// and a wait for the card at every association of every registration, the
// only read-backs of a frame besides its result. This kernel computes the
// same function with none. The Python wrapper
// (lmsf_slam_tpu_torch/ops/projector.py) allocates the outputs and launches;
// projector_jacobi_plain there models this kernel operation for operation.
//
// The function, for each 6x6 float32 H (JᵀWJ of one Gauss-Newton
// iteration; its lower triangle is read, as torch.linalg.eigh reads it):
//   finite = every entry of H is finite;
//   A = (finite ? H : I) + damping I, in float64;
//   (λ, V) = eigen-decomposition of A;
//   thresh = nmatch ? degen_rel * (float)nmatch : degen_thresh, in float32;
//   ok_i = finite && (float)λ_i > thresh;
//   P = Σ_{ok_i} v_i v_iᵀ (float64), or NaN everywhere when !finite;
//   n_con = Σ ok_i.
// P does not depend on the order or the signs of the eigenvectors, so the
// kernel need not sort them.
//
// What bounds it on this card. One matrix moves 36 x 4 bytes in and
// 36 x 8 + 8 out: 1.3e-7 ms at 3.35 TB/s. The function's own work is less:
// ~140 FP64 operations to prove every eigenvalue above the floor (the screen
// below), else a 6x6 symmetric eigendecomposition and P, ~9n³ + 432 ≈ 2.4 k
// (7e-8 ms at 34 TFLOP/s). So the bound is the bytes (tests/kernel_cases.py,
// projector_bound_ms). The practical floor is an empty launch (~0.0017 ms);
// above it, the latency of one chain of dependent float64 operations: the
// H100 has no FP64 unit for square roots or divides, each is a Newton
// sequence of dependent DFMAs. Tensor cores, TMA and wgmma have nothing to do
// with 288 bytes of input. The path hands the kernel one matrix at a time.
//
// What the design does about it, in two parts.
//
// 1. The screen. On the path every eigenvalue clears the floor, and then
//    P = Σ v_i v_iᵀ = V Vᵀ = I whatever V is. So before any decomposition the
//    kernel proves λ_min(A) above the floor by one LDLᵀ. Let m be the float64
//    midpoint of thresh and nextafterf(thresh, +inf) (exact in float64);
//    λ > m makes (float)λ > thresh certain. With
//        η = SCREEN_ULPS · EPS · (‖A‖∞ + |m|),     s = m + η,
//    the kernel factors S = fl(A − sI) = L D Lᵀ in float64 (a reciprocal a
//    pivot). If all six pivots are positive, then L D Lᵀ = S + ΔS is positive
//    definite with ‖ΔS‖₂ ≤ γ₈ tr(|L||D||Lᵀ|) ≲ 4 n EPS (‖A‖∞ + |s|) (Higham,
//    Accuracy and Stability of Numerical Algorithms, 2nd ed., Thm 10.3 and
//    §10.4; γ₈ for the 6 terms of a sum, the product and the reciprocal), and
//    the subtraction of s moved A by at most EPS (‖A‖∞ + |s|). So
//    λ_min(A) > s − 25 EPS (‖A‖∞ + |s|) ≥ m + ~350 EPS (‖A‖∞ + |m|): above m by
//    more than the error of any backward-stable eigensolver of a 6x6 matrix
//    (Jacobi's here, cuSOLVER's or LAPACK's in the plain version), so they
//    too find every eigenvalue above the floor. The kernel then writes P = I
//    and n_con = 6 and skips the decomposition (sweeps 0). A matrix with a
//    pivot ≤ 0, a non-finite H, or an s that is not finite (a floor near
//    FLT_MAX) goes to Jacobi; the screen may send one there that did not need
//    it, never the other way.
//
// 2. Jacobi, one thread a matrix, where the screen does not pass (a corridor:
//    a direction under the floor). A and V stay in registers: every loop is
//    unrolled over compile-time indices. Cyclic Jacobi (Rutishauser's update,
//    Golub & Van Loan 8.5) visits the 15 pairs (p, q) in row order, rotating
//    where |a_pq| > EPS sqrt|a_pp a_qq|, until a sweep rotates nothing (1-6
//    sweeps for these matrices) or MAX_SWEEPS. Each operation is rounded on
//    its own (__dmul_rn and its kin: no FMA), so the plain model repeats the
//    kernel bit for bit: the screen's decisions, sweeps and eigenvalues.
//
// A batch of B matrices is B threads, 128 a block. Arithmetic: float64
// throughout (the projector enters the step as κ(I − P) with κ = 1e7, so
// float32 rounding of P would move the step); the floor is compared in
// float32, as the reference compares it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N = 6;
constexpr int THREADS = 128;
constexpr int MAX_SWEEPS = 30;
constexpr int SCREEN_ULPS = 64 * N;       // η = SCREEN_ULPS · EPS · (‖A‖∞ + |m|)
constexpr double EPS = 2.220446049250313e-16;  // float64 machine epsilon

// each operation rounded on its own, as the plain model computes
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }

// The screen: true when the LDLᵀ of A − (m + η) I has six positive pivots,
// so every eigenvalue clears the floor.
__device__ __forceinline__ bool screen(const double (&a)[N][N], float thresh) {
    const double mid = 0.5 * (static_cast<double>(thresh) +
                              static_cast<double>(nextafterf(thresh, INFINITY)));
    double norm = 0.0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        double row = 0.0;
#pragma unroll
        for (int j = 0; j < N; ++j) row = add(row, fabs(a[i][j]));
        norm = fmax(norm, row);
    }
    const double shift = add(mid, mul(SCREEN_ULPS * EPS, add(norm, fabs(mid))));
    if (!isfinite(shift)) return false;
    double w[N][N], l[N][N];  // W = L D below the diagonal
    bool pd = true;
#pragma unroll
    for (int j = 0; j < N; ++j) {
        double d = sub(a[j][j], shift);
#pragma unroll
        for (int k = 0; k < j; ++k) d = sub(d, mul(w[j][k], l[j][k]));
        pd = pd && d > 0.0;
        const double rd = dvd(1.0, d);
#pragma unroll
        for (int i = j + 1; i < N; ++i) {
            double x = a[i][j];
#pragma unroll
            for (int k = 0; k < j; ++k) x = sub(x, mul(w[i][k], l[j][k]));
            w[i][j] = x;
            l[i][j] = mul(x, rd);
        }
    }
    return pd;
}

// One Jacobi rotation in the (p, q) plane of the symmetric matrix a, applied
// to the eigenvector matrix v as well. Returns whether it rotated.
template <int p, int q>
__device__ __forceinline__ bool rotate(double (&a)[N][N], double (&v)[N][N]) {
    const double apq = a[p][q], app = a[p][p], aqq = a[q][q];
    if (fabs(apq) <= mul(EPS, __dsqrt_rn(fabs(mul(app, aqq))))) return false;
    const double theta = dvd(sub(aqq, app), mul(2.0, apq));
    // t = tan of the rotation angle, the smaller root; 1/(2θ) where θ² would
    // overflow
    const double t = fabs(theta) > 1e150
                         ? dvd(0.5, theta)
                         : dvd(copysign(1.0, theta),
                               add(fabs(theta), __dsqrt_rn(add(mul(theta, theta), 1.0))));
    const double c = dvd(1.0, __dsqrt_rn(add(mul(t, t), 1.0)));
    const double s = mul(t, c);
    const double tau = dvd(s, add(1.0, c));
    a[p][p] = sub(app, mul(t, apq));
    a[q][q] = add(aqq, mul(t, apq));
    a[p][q] = 0.0;
    a[q][p] = 0.0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
        if (k != p && k != q) {
            const double akp = a[k][p], akq = a[k][q];
            a[k][p] = sub(akp, mul(s, add(akq, mul(tau, akp))));
            a[k][q] = add(akq, mul(s, sub(akp, mul(tau, akq))));
            a[p][k] = a[k][p];
            a[q][k] = a[k][q];
        }
        const double vkp = v[k][p], vkq = v[k][q];
        v[k][p] = sub(vkp, mul(s, add(vkq, mul(tau, vkp))));
        v[k][q] = add(vkq, mul(s, sub(vkp, mul(tau, vkq))));
    }
    return true;
}

// One sweep: the 15 pairs in row order. Returns whether any rotated.
__device__ __forceinline__ bool sweep(double (&a)[N][N], double (&v)[N][N]) {
    bool r = false;
    r |= rotate<0, 1>(a, v); r |= rotate<0, 2>(a, v); r |= rotate<0, 3>(a, v);
    r |= rotate<0, 4>(a, v); r |= rotate<0, 5>(a, v); r |= rotate<1, 2>(a, v);
    r |= rotate<1, 3>(a, v); r |= rotate<1, 4>(a, v); r |= rotate<1, 5>(a, v);
    r |= rotate<2, 3>(a, v); r |= rotate<2, 4>(a, v); r |= rotate<2, 5>(a, v);
    r |= rotate<3, 4>(a, v); r |= rotate<3, 5>(a, v); r |= rotate<4, 5>(a, v);
    return r;
}

__global__ void __launch_bounds__(THREADS)
projector_kernel(const float* __restrict__ H, const int32_t* __restrict__ nmatch, int B,
                 double damping, float degen_rel, float degen_thresh,
                 double* __restrict__ P, int32_t* __restrict__ n_con,
                 int32_t* __restrict__ sweeps) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const float* h = H + static_cast<int64_t>(b) * N * N;

    // A from H's lower triangle; finite over all 36 entries, each loaded
    // unconditionally (a load behind the last one's test would wait for it)
    float x[N * N];
    bool finite = true;
#pragma unroll
    for (int e = 0; e < N * N; ++e) finite &= isfinite(x[e] = h[e]);
    double a[N][N], v[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const double aij = finite ? static_cast<double>(x[i >= j ? i * N + j : j * N + i])
                                      : (i == j ? 1.0 : 0.0);
            a[i][j] = i == j ? add(aij, damping) : aij;
            v[i][j] = i == j ? 1.0 : 0.0;
        }
    }

    const float thresh = nmatch != nullptr
                             ? __fmul_rn(degen_rel, static_cast<float>(nmatch[b]))
                             : degen_thresh;
    double* out = P + static_cast<int64_t>(b) * N * N;
    if (finite && screen(a, thresh)) {
#pragma unroll
        for (int e = 0; e < N * N; ++e) out[e] = e / N == e % N ? 1.0 : 0.0;
        n_con[b] = N;
        if (sweeps != nullptr) sweeps[b] = 0;
        return;
    }

    int s = 0;
    while (s < MAX_SWEEPS && sweep(a, v)) ++s;

    double ok[N];
    int count = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const bool keep = finite && __double2float_rn(a[i][i]) > thresh;
        ok[i] = keep ? 1.0 : 0.0;
        count += keep;
    }
#pragma unroll
    for (int e = 0; e < N * N; ++e) {
        double acc = 0.0;
#pragma unroll
        for (int k = 0; k < N; ++k) acc += ok[k] * v[e / N][k] * v[e % N][k];
        out[e] = finite ? acc : nan("");
    }
    n_con[b] = count;
    if (sweeps != nullptr) sweeps[b] = s;
}

}  // namespace

extern "C" int projector_threads() { return THREADS; }
extern "C" int projector_max_sweeps() { return MAX_SWEEPS; }
extern "C" int projector_screen_ulps() { return SCREEN_ULPS; }

// H: (B, 6, 6) float32; nmatch: (B,) int32 or null (then the floor is
// degen_thresh); P: (B, 6, 6) float64; n_con: (B,) int32; sweeps: (B,) int32
// or null (0 for a screened matrix). Returns cudaGetLastError() after the
// launch.
extern "C" int projector_launch(const void* H, const void* nmatch, int B, double damping,
                                float degen_rel, float degen_thresh, void* P, void* n_con,
                                void* sweeps, void* stream) {
    if (B <= 0) return -1;
    const int blocks = (B + THREADS - 1) / THREADS;
    projector_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(H), static_cast<const int32_t*>(nmatch), B, damping,
        degen_rel, degen_thresh, static_cast<double*>(P), static_cast<int32_t*>(n_con),
        static_cast<int32_t*>(sweeps));
    return static_cast<int>(cudaGetLastError());
}
