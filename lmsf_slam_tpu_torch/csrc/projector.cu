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
// (lmsf_slam_tpu_torch/ops/projector.py) allocates the outputs and launches.
//
// The function, for each 6x6 float32 H (JᵀWJ of one Gauss-Newton
// iteration):
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
// What bounds it on this card. One decomposition moves 36 x 4 bytes in and
// 36 x 8 + 8 out (~0.1 ns at 3.35 TB/s) and needs ~81 FP64 operations a
// Jacobi rotation, 15 rotations a sweep, 6-10 sweeps, plus ~430 for P:
// ~10 k operations, ~0.3 ns at the H100's 34 TFLOP/s FP64 rate. Neither
// bounds it: the chain of dependent double-precision operations of one
// thread and the launch do. The path hands it one matrix at a time.
//
// What the design does about it. One thread a matrix, the whole matrix and
// the eigenvectors in registers (every loop is unrolled over compile-time
// indices, so no array is addressed at run time and nothing goes to local
// memory). Cyclic Jacobi (Rutishauser's update, as in Golub & Van Loan
// 8.5): each sweep visits the 15 pairs (p, q) in row order and rotates where
// |a_pq| > eps * sqrt(|a_pp a_qq|); the loop stops after the first sweep
// that rotates nothing (quadratic convergence: 6-10 sweeps for these
// matrices), or at MAX_SWEEPS. Jacobi's eigenvalues of a positive definite
// matrix are accurate to a few units of rounding relative to each
// eigenvalue, at least as close as LAPACK's to the exact ones. A batch of B
// matrices is B threads, 128 a block.
//
// Arithmetic: float64 throughout, as the plain version (the projector enters
// the step as κ(I − P) with κ = 1e7, so float32 rounding of P would move
// the step); the floor is compared in float32, as the reference compares it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N = 6;
constexpr int THREADS = 128;
constexpr int MAX_SWEEPS = 30;
constexpr double EPS = 2.220446049250313e-16;  // float64 machine epsilon

// One Jacobi rotation in the (p, q) plane of the symmetric matrix a, applied
// to the eigenvector matrix v as well. Returns whether it rotated.
template <int p, int q>
__device__ __forceinline__ bool rotate(double (&a)[N][N], double (&v)[N][N]) {
    const double apq = a[p][q];
    if (fabs(apq) <= EPS * sqrt(fabs(a[p][p] * a[q][q]))) return false;
    const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
    // t = tan of the rotation angle, the smaller root; 1/(2θ) where θ² would
    // overflow
    const double t = fabs(theta) > 1e150
                         ? 0.5 / theta
                         : copysign(1.0, theta) / (fabs(theta) + sqrt(theta * theta + 1.0));
    const double c = 1.0 / sqrt(t * t + 1.0);
    const double s = t * c;
    const double tau = s / (1.0 + c);
    a[p][p] -= t * apq;
    a[q][q] += t * apq;
    a[p][q] = 0.0;
    a[q][p] = 0.0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
        if (k != p && k != q) {
            const double akp = a[k][p], akq = a[k][q];
            a[k][p] = akp - s * (akq + tau * akp);
            a[k][q] = akq + s * (akp - tau * akq);
            a[p][k] = a[k][p];
            a[q][k] = a[k][q];
        }
        const double vkp = v[k][p], vkq = v[k][q];
        v[k][p] = vkp - s * (vkq + tau * vkp);
        v[k][q] = vkq + s * (vkp - tau * vkq);
    }
    return true;
}

__device__ __forceinline__ bool sweep(double (&a)[N][N], double (&v)[N][N]) {
    bool r = false;
    r |= rotate<0, 1>(a, v); r |= rotate<0, 2>(a, v); r |= rotate<0, 3>(a, v);
    r |= rotate<0, 4>(a, v); r |= rotate<0, 5>(a, v);
    r |= rotate<1, 2>(a, v); r |= rotate<1, 3>(a, v); r |= rotate<1, 4>(a, v);
    r |= rotate<1, 5>(a, v);
    r |= rotate<2, 3>(a, v); r |= rotate<2, 4>(a, v); r |= rotate<2, 5>(a, v);
    r |= rotate<3, 4>(a, v); r |= rotate<3, 5>(a, v);
    r |= rotate<4, 5>(a, v);
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

    double a[N][N], v[N][N];
    bool finite = true;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const float x = h[i * N + j];
            finite = finite && isfinite(x);
            a[i][j] = static_cast<double>(x);
            v[i][j] = i == j ? 1.0 : 0.0;
        }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
            if (!finite) a[i][j] = i == j ? 1.0 : 0.0;
        }
        a[i][i] += damping;
    }

    int s = 0;
    while (s < MAX_SWEEPS && sweep(a, v)) ++s;

    const float thresh = nmatch != nullptr
                             ? __fmul_rn(degen_rel, static_cast<float>(nmatch[b]))
                             : degen_thresh;
    double ok[N];
    int count = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const bool keep = finite && __double2float_rn(a[i][i]) > thresh;
        ok[i] = keep ? 1.0 : 0.0;
        count += keep;
    }
    double* out = P + static_cast<int64_t>(b) * N * N;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
            double acc = 0.0;
#pragma unroll
            for (int k = 0; k < N; ++k) acc += ok[k] * v[i][k] * v[j][k];
            out[i * N + j] = finite ? acc : nan("");
        }
    }
    n_con[b] = count;
    if (sweeps != nullptr) sweeps[b] = s;
}

}  // namespace

extern "C" int projector_threads() { return THREADS; }
extern "C" int projector_max_sweeps() { return MAX_SWEEPS; }

// H: (B, 6, 6) float32; nmatch: (B,) int32 or null (then the floor is
// degen_thresh); P: (B, 6, 6) float64; n_con: (B,) int32; sweeps: (B,) int32
// or null. Returns cudaGetLastError() after the launch.
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
