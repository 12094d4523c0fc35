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
// (7e-8 ms at 34 TFLOP/s). So the bound is the bytes, 1.3e-7 ms a matrix
// (chip_smoke.py, projector_bound_ms). The practical floor is an empty launch (~0.0017 ms);
// above it, the latency of one chain of dependent float64 operations. The
// H100 has no FP64 unit for square roots or divides: each is a Newton
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
// 2. Jacobi, one warp a matrix. A and V live in shared memory. A sweep is a
//    round-robin (circle method) ordering of the 15 pairs: 5 rounds of 3
//    disjoint pairs, which together cover all 6 indices. In a round lanes
//    0..2 each decide and compute one rotation (rotate where
//    |a_pq| > EPS sqrt|a_pp a_qq|; Rutishauser's update, Golub & Van Loan
//    8.5), then the warp applies the block rotation Jᵀ A J: 21 lanes one
//    entry each of A's upper triangle (the column rotation of j's pair, then
//    the row rotation of i's pair; a rotated pair's own 2x2 block becomes
//    diag(a_pp − t a_pq, a_qq + t a_pq)), mirrored to the lower, and all 32
//    lanes the 36 entries of V J. The three rotations of a round touch
//    disjoint rows and columns, so in exact arithmetic the round equals
//    applying them one after another. The serial chain drops from 15
//    rotations a sweep to 5 rounds. Each lane computes every candidate value
//    of its entry and selects: a branch on its own flags would split the
//    warp into paths run one after another. At the start of a sweep lanes
//    0..14 take the 15 pair tests at once; a sweep rotates nothing exactly
//    when none passes, so the warp stops there instead of walking 5 rounds
//    to find out. Otherwise it stops after a sweep that rotates nothing, or
//    at MAX_SWEEPS. Jacobi's eigenvalues of a positive definite matrix are
//    accurate to a few units of rounding relative to each eigenvalue. Every
//    operation is rounded on its own (__dmul_rn and its kin: no FMA
//    contraction), so the plain model repeats the kernel bit for bit: the
//    same screen decisions, sweeps and eigenvalues.
//
//    A round's time is the rotation's chain (six dependent float64 divides
//    and roots) plus the hand-off through shared memory and the block
//    update. Computing all three rotations in every lane would drop the
//    hand-off but makes three chains share the warp's FP64 units, and was
//    slower in trials on the card; so three lanes compute and the warp reads.
//
// A batch of B matrices is B warps, 4 a block. Arithmetic: float64
// throughout (the projector enters the step as κ(I − P) with κ = 1e7, so
// float32 rounding of P would move the step); the floor is compared in
// float32, as the reference compares it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N = 6;
constexpr int THREADS = 128;
constexpr int WARP = 32;
constexpr int MATRICES = THREADS / WARP;  // one warp a matrix
constexpr int ROUNDS = N - 1;             // a sweep: 5 rounds of 3 disjoint pairs
constexpr int MAX_SWEEPS = 30;
constexpr int SCREEN_ULPS = 64 * N;       // η = SCREEN_ULPS · EPS · (‖A‖∞ + |m|)
constexpr double EPS = 2.220446049250313e-16;  // float64 machine epsilon
constexpr unsigned FULL = 0xffffffffu;

// each operation rounded on its own, as the plain model computes
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }

// Index i's partner in round r of the circle method: N-1 stays, the others
// turn; pair k of round r is (r, N-1) for k = 0 and ((r+k) % 5, (r-k) % 5).
__device__ __forceinline__ int partner(int r, int i) {
    if (i == N - 1) return r;
    if (i == r) return N - 1;
    return (2 * r - i + 2 * ROUNDS) % ROUNDS;
}

struct Matrix {
    double a[N][N];
    double v[N][N];
    // the round's rotation seen from each index: s, τ and t negated for the
    // first index of its pair, so that one formula serves both ends
    double s[N], tau[N], t[N];
    int rot[N];
};

// new_self = x_self + s (x_other − τ x_self): Rutishauser's two updates
// (x_p − s (x_q + τ x_p) and x_q + s (x_p − τ x_q)) with signed s and τ
__device__ __forceinline__ double turn(double self, double other, double s, double tau) {
    return add(self, mul(s, sub(other, mul(tau, self))));
}

// The rotation test of the pair (p, q): |a_pq| > EPS sqrt|a_pp a_qq|.
__device__ __forceinline__ bool rotates(const Matrix& m, int p, int q) {
    return fabs(m.a[p][q]) > mul(EPS, __dsqrt_rn(fabs(mul(m.a[p][p], m.a[q][q]))));
}

// Lane k < 3 decides and computes the rotation of pair k of round r. The
// test's square root runs beside the rotation's chain of divides and roots,
// and no branch splits the three lanes.
__device__ __forceinline__ void rotation(Matrix& m, int r, int k) {
    int p = k == 0 ? r : (r + k) % ROUNDS, q = k == 0 ? N - 1 : (r - k + ROUNDS) % ROUNDS;
    if (p > q) { const int x = p; p = q; q = x; }
    const double apq = m.a[p][q], app = m.a[p][p], aqq = m.a[q][q];
    const double theta = dvd(sub(aqq, app), mul(2.0, apq != 0.0 ? apq : 1.0));
    // t = tan of the rotation angle, the smaller root; 1/(2θ) where θ² would
    // overflow
    const double t = fabs(theta) > 1e150
                         ? dvd(0.5, theta)
                         : dvd(copysign(1.0, theta),
                               add(fabs(theta), __dsqrt_rn(add(mul(theta, theta), 1.0))));
    const double c = dvd(1.0, __dsqrt_rn(add(mul(t, t), 1.0)));
    const double s = mul(t, c);
    const double tau = dvd(s, add(1.0, c));
    const bool rot = rotates(m, p, q);
    m.s[p] = -s; m.tau[p] = -tau; m.t[p] = -t; m.rot[p] = rot;
    m.s[q] = s;  m.tau[q] = tau;  m.t[q] = t;  m.rot[q] = rot;
}

// What a lane works on, fixed for the whole decomposition: the entry (i, j),
// i <= j, of A's upper triangle (lanes 0..20), the entries e0 = lane and
// e1 = lane + 32 of V (e1 for lanes 0..3), and the pair (p, q), p < q,
// whose test it takes at the start of a sweep (lanes 0..14).
struct Lane {
    int lane, i, j, p, q;
    bool upper, second, tests;
};

__device__ __forceinline__ Lane lane_of(int lane) {
    Lane l{lane, 0, 0, 0, 1, lane < N * (N + 1) / 2, lane + WARP < N * N,
           lane < N * (N - 1) / 2};
    int j = l.upper ? lane : 0;
    while (j >= N - l.i) { j -= N - l.i; ++l.i; }
    l.j = l.i + j;
    int q = l.tests ? lane : 0;
    while (q >= N - 1 - l.p) { q -= N - 1 - l.p; ++l.p; }
    l.q = l.p + 1 + q;
    return l;
}

// V J at entry (k, c): the column rotation of c's pair
__device__ __forceinline__ double v_turned(const Matrix& m, int r, int e) {
    const int k = e / N, c = e % N;
    const double x = m.v[k][c];
    const double turned = turn(x, m.v[k][partner(r, c)], m.s[c], m.tau[c]);
    return m.rot[c] ? turned : x;
}

// One round: three rotations, then the block rotation of A and V. Every lane
// computes every candidate and selects (a branch on the lane's own flags
// would split the warp into paths that run one after another). Returns
// whether it rotated (the same in every lane). The caller synchronises the
// warp after the last round.
__device__ __forceinline__ bool round_robin(Matrix& m, int r, const Lane& l) {
    __syncwarp();  // the last round's writes and reads are done
    if (l.lane < 3) rotation(m, r, l.lane);
    __syncwarp();
    const bool any = m.rot[0] | m.rot[1] | m.rot[2] | m.rot[3] | m.rot[4] | m.rot[5];
    if (!any) return false;  // every lane reads the same flags
    const int i = l.i, j = l.j, ip = partner(r, i), jp = partner(r, j);
    const double aij = m.a[i][j], aijp = m.a[i][jp], aipj = m.a[ip][j], aipjp = m.a[ip][jp];
    const bool ri = m.rot[i], rj = m.rot[j];
    // column rotation of j's pair on rows i and i', then the row rotation of
    // i's pair; a rotated pair's own block: its diagonal update, 0 off it
    const double yi_t = turn(aij, aijp, m.s[j], m.tau[j]);
    const double yp_t = turn(aipj, aipjp, m.s[j], m.tau[j]);
    const double yi = rj ? yi_t : aij, yp = rj ? yp_t : aipj;
    const double general_t = turn(yi, yp, m.s[i], m.tau[i]);
    const double diagonal_t = add(aij, mul(m.t[i], aijp));
    const double turned = i == j ? diagonal_t : j == ip ? 0.0 : general_t;
    const double a_new = ri ? turned : (i == j || j == ip ? aij : yi);
    const double v0 = v_turned(m, r, l.lane);
    const double v1 = v_turned(m, r, l.second ? l.lane + WARP : l.lane);
    __syncwarp();
    if (l.upper) {
        m.a[i][j] = a_new;
        m.a[j][i] = a_new;
    }
    m.v[l.lane / N][l.lane % N] = v0;
    if (l.second) m.v[(l.lane + WARP) / N][(l.lane + WARP) % N] = v1;
    return true;
}

// The screen (every lane the same, from shared A): true when the LDLᵀ of
// A − (m + η) I has six positive pivots, so every eigenvalue clears the floor.
__device__ __forceinline__ bool screen(const Matrix& m, float thresh) {
    const double mid = 0.5 * (static_cast<double>(thresh) +
                              static_cast<double>(nextafterf(thresh, INFINITY)));
    double norm = 0.0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        double row = 0.0;
#pragma unroll
        for (int j = 0; j < N; ++j) row = add(row, fabs(m.a[i][j]));
        norm = fmax(norm, row);
    }
    const double shift = add(mid, mul(SCREEN_ULPS * EPS, add(norm, fabs(mid))));
    if (!isfinite(shift)) return false;
    double w[N][N], l[N][N];  // W = L D below the diagonal
    bool pd = true;
#pragma unroll
    for (int j = 0; j < N; ++j) {
        double d = sub(m.a[j][j], shift);
#pragma unroll
        for (int k = 0; k < j; ++k) d = sub(d, mul(w[j][k], l[j][k]));
        pd = pd && d > 0.0;
        const double rd = dvd(1.0, d);
#pragma unroll
        for (int i = j + 1; i < N; ++i) {
            double x = m.a[i][j];
#pragma unroll
            for (int k = 0; k < j; ++k) x = sub(x, mul(w[i][k], l[j][k]));
            w[i][j] = x;
            l[i][j] = mul(x, rd);
        }
    }
    return pd;
}

__global__ void __launch_bounds__(THREADS)
projector_kernel(const float* __restrict__ H, const int32_t* __restrict__ nmatch, int B,
                 double damping, float degen_rel, float degen_thresh,
                 double* __restrict__ P, int32_t* __restrict__ n_con,
                 int32_t* __restrict__ sweeps) {
    __shared__ Matrix mats[MATRICES];
    const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    const int b = blockIdx.x * MATRICES + w;
    if (b >= B) return;  // a whole warp leaves together
    Matrix& m = mats[w];
    const float* h = H + static_cast<int64_t>(b) * N * N;

    // A from H's lower triangle; finite over all 36 entries
    bool finite = true;
    double x[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int e = lane + k * WARP;
        if (e < N * N) {
            const int i = e / N, j = e % N;
            finite = finite && isfinite(h[e]);
            x[k] = static_cast<double>(h[i >= j ? e : j * N + i]);
        }
    }
    finite = __all_sync(FULL, finite);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int e = lane + k * WARP;
        if (e < N * N) {
            const int i = e / N, j = e % N;
            const double aij = finite ? x[k] : (i == j ? 1.0 : 0.0);
            m.a[i][j] = i == j ? add(aij, damping) : aij;
            m.v[i][j] = i == j ? 1.0 : 0.0;
        }
    }
    __syncwarp();

    const float thresh = nmatch != nullptr
                             ? __fmul_rn(degen_rel, static_cast<float>(nmatch[b]))
                             : degen_thresh;
    double* out = P + static_cast<int64_t>(b) * N * N;
    if (finite && screen(m, thresh)) {
        for (int e = lane; e < N * N; e += WARP) out[e] = e / N == e % N ? 1.0 : 0.0;
        if (lane == 0) {
            n_con[b] = N;
            if (sweeps != nullptr) sweeps[b] = 0;
        }
        return;
    }

    const Lane l = lane_of(lane);
    int s = 0;
    while (s < MAX_SWEEPS) {
        // A sweep rotates nothing exactly when no pair passes the test on A
        // as it stands: 15 lanes take the 15 tests at once, and the warp
        // stops without walking the 5 rounds
        __syncwarp();
        if (!__any_sync(FULL, l.tests && rotates(m, l.p, l.q))) break;
        bool rotated = false;
        for (int r = 0; r < ROUNDS; ++r) rotated |= round_robin(m, r, l);
        if (!rotated) break;
        ++s;
    }
    __syncwarp();

    double ok[N];
    int count = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const bool keep = finite && __double2float_rn(m.a[i][i]) > thresh;
        ok[i] = keep ? 1.0 : 0.0;
        count += keep;
    }
    for (int e = lane; e < N * N; e += WARP) {
        const int i = e / N, j = e % N;
        double acc = 0.0;
#pragma unroll
        for (int k = 0; k < N; ++k) acc += ok[k] * m.v[i][k] * m.v[j][k];
        out[e] = finite ? acc : nan("");
    }
    if (lane == 0) {
        n_con[b] = count;
        if (sweeps != nullptr) sweeps[b] = s;
    }
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
    const int blocks = (B + MATRICES - 1) / MATRICES;
    projector_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(H), static_cast<const int32_t*>(nmatch), B, damping,
        degen_rel, degen_thresh, static_cast<double*>(P), static_cast<int32_t*>(n_con),
        static_cast<int32_t*>(sweeps));
    return static_cast<int>(cudaGetLastError());
}
