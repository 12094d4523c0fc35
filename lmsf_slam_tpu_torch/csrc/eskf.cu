// The ESKF propagation over one IMU window, for Hopper (sm_90a): one kernel,
// eskf_propagate_kernel.
//
// Replaces no TPU kernel. The reference propagates a window with a lax.scan
// over eskf_predict (lmsf_slam_tpu/estimator/eskf.py), which XLA compiles
// into one program. The port's plain version is eskf_run's Python loop over
// eskf_predict (lmsf_slam_tpu_torch/estimator/eskf.py): ~165 small torch
// launches a sample, ~1650 for the
// 10 samples of a 100 Hz IMU between two 10 Hz scans, all host time. This
// kernel computes the same window in one launch. The Python wrapper
// (eskf.py::eskf_propagate_cuda) allocates the outputs and launches.
//
// The function, for a window of N >= 1 samples (gyro_i, acc_i, dt_i), each
// step exactly eskf_predict's in float32, sample i paired with sample i+1
// (the last with itself):
//   w = 0.5 (g_i + g_{i+1}) − bg;   q⁺ = q ⊗ exp(w dt);
//   a = 0.5 (R(q)(a_i − ba) + R(q⁺)(a_{i+1} − ba)) − [0 0 g];
//   p ← p + v dt + 0.5 a dt²;   v ← v + a dt;   q ← normalize(q⁺);
//   F = I15 with F[p,v] = I3 dt, F[v,θ] = −R skew(0.5 (a_i + a_{i+1}) − ba) dt,
//       F[v,ba] = −R dt, F[θ,θ] = I3 − skew(w dt), F[θ,bg] = −I3 dt;
//   P ← F P Fᵀ + diag(rates dt).
// ba and bg pass through. No per-sample trajectory is kept: the program
// reads only the final state.
//
// What bounds it on this card. The work is tiny: ~2 KB of state and samples
// in and out (2.2 KB at N = 10: 6.6e-7 ms at 3.35 TB/s) and two 15x15
// products a sample, ~135 kFLOP at N = 10 (2.0e-6 ms at 67 TFLOP/s). Neither
// is the limit. The steps form one dependent chain, so the kernel is bound by
// latency: a launch (~0.002 ms) and then, per sample, the nominal state's
// chain of dependent float32 operations (two quaternion products, an
// exponential, two rotations) and two 15-term dot products through shared
// memory with a barrier after each.
//
// What the design does about it: one launch a window and a serial loop in
// shared memory. One block holds the covariance P, the product T = F P and F
// in shared memory for the whole window; nothing goes to device memory
// between samples. Each sample, thread 0 steps the nominal state, which it
// carries in registers, and writes F's blocks; then threads 0..224 each own
// one entry of T and of P: T[r][c] = Σ_k F[r][k] P[k][c], then
// P[r][c] = Σ_k T[r][k] F[c][k] + (r == c) rates_r dt, each a 15-term sum in
// k order with fused multiply-adds (no atomics: two runs agree bit for bit).
// The nominal state's operations are rounded one at a time (__fmul_rn and
// its kin, no contraction into FMAs), in eskf_predict's order, so that the
// state follows the plain version's rounding where the two compute alike.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 15;                 // error state [δp δv δθ δba δbg]
constexpr int P0 = 0, V0 = 3, TH0 = 6, BA0 = 9, BG0 = 12;
constexpr int THREADS = D * D;        // one a covariance entry; thread 0 also the nominal state

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

struct Vec3 { float x, y, z; };
struct Quat { float w, x, y, z; };

__device__ __forceinline__ Vec3 vsub(Vec3 a, Vec3 b) { return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)}; }
__device__ __forceinline__ Vec3 vadd(Vec3 a, Vec3 b) { return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)}; }
__device__ __forceinline__ Vec3 vscale(float s, Vec3 a) { return {mul(s, a.x), mul(s, a.y), mul(s, a.z)}; }

// torch.linalg.cross(a, b)
__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
    return {sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
            sub(mul(a.x, b.y), mul(a.y, b.x))};
}

// se3.quat_normalize: q / max(|q|, 1e-8), then w >= 0
__device__ __forceinline__ Quat normalize(Quat q) {
    const float n = fmaxf(__fsqrt_rn(add(add(add(mul(q.w, q.w), mul(q.x, q.x)), mul(q.y, q.y)),
                                         mul(q.z, q.z))), 1e-8f);
    Quat r{dvd(q.w, n), dvd(q.x, n), dvd(q.y, n), dvd(q.z, n)};
    if (r.w < 0.0f) r = {-r.w, -r.x, -r.y, -r.z};
    return r;
}

// se3.quat_mul(a, b)
__device__ __forceinline__ Quat qmul(Quat a, Quat b) {
    return {sub(sub(sub(mul(a.w, b.w), mul(a.x, b.x)), mul(a.y, b.y)), mul(a.z, b.z)),
            sub(add(add(mul(a.w, b.x), mul(a.x, b.w)), mul(a.y, b.z)), mul(a.z, b.y)),
            add(add(sub(mul(a.w, b.y), mul(a.x, b.z)), mul(a.y, b.w)), mul(a.z, b.x)),
            add(sub(add(mul(a.w, b.z), mul(a.x, b.y)), mul(a.y, b.x)), mul(a.z, b.w))};
}

// se3.so3_exp_quat(w): Taylor terms below θ² = 1e-8
__device__ __forceinline__ Quat exp_quat(Vec3 w) {
    const float theta2 = add(add(mul(w.x, w.x), mul(w.y, w.y)), mul(w.z, w.z));
    const float theta = __fsqrt_rn(fmaxf(theta2, 1e-16f));
    const float half = mul(0.5f, theta);
    const bool small = theta2 < 1e-8f;
    const float k = small ? sub(0.5f, dvd(theta2, 48.0f)) : dvd(sinf(half), theta);
    const float qw = small ? sub(1.0f, dvd(theta2, 8.0f)) : cosf(half);
    return normalize({qw, mul(k, w.x), mul(k, w.y), mul(k, w.z)});
}

// se3.quat_rotate(q, v): v + w t + qv × t, t = 2 qv × v
__device__ __forceinline__ Vec3 rotate(Quat q, Vec3 v) {
    const Vec3 qv{q.x, q.y, q.z};
    const Vec3 t = vscale(2.0f, cross(qv, v));
    return vadd(vadd(v, vscale(q.w, t)), cross(qv, t));
}

// se3.quat_to_matrix(q)
__device__ __forceinline__ void to_matrix(Quat q, float R[3][3]) {
    const float xx = mul(q.x, q.x), yy = mul(q.y, q.y), zz = mul(q.z, q.z);
    const float xy = mul(q.x, q.y), xz = mul(q.x, q.z), yz = mul(q.y, q.z);
    const float wx = mul(q.w, q.x), wy = mul(q.w, q.y), wz = mul(q.w, q.z);
    R[0][0] = sub(1.0f, mul(2.0f, add(yy, zz)));
    R[0][1] = mul(2.0f, sub(xy, wz));
    R[0][2] = mul(2.0f, add(xz, wy));
    R[1][0] = mul(2.0f, add(xy, wz));
    R[1][1] = sub(1.0f, mul(2.0f, add(xx, zz)));
    R[1][2] = mul(2.0f, sub(yz, wx));
    R[2][0] = mul(2.0f, sub(xz, wy));
    R[2][1] = mul(2.0f, add(yz, wx));
    R[2][2] = sub(1.0f, mul(2.0f, add(xx, yy)));
}

// se3.skew(v)
__device__ __forceinline__ void skew(Vec3 v, float S[3][3]) {
    S[0][0] = 0.0f; S[0][1] = -v.z; S[0][2] = v.y;
    S[1][0] = v.z;  S[1][1] = 0.0f; S[1][2] = -v.x;
    S[2][0] = -v.y; S[2][1] = v.x;  S[2][2] = 0.0f;
}

struct Window {
    const float* gyro;
    const float* acc;
    const float* dt;
    int64_t gyro_row, gyro_col, acc_row, acc_col, dt_step;
    int n;

    __device__ Vec3 g(int i) const {
        const float* r = gyro + i * gyro_row;
        return {r[0], r[gyro_col], r[2 * gyro_col]};
    }
    __device__ Vec3 a(int i) const {
        const float* r = acc + i * acc_row;
        return {r[0], r[acc_col], r[2 * acc_col]};
    }
    __device__ float step(int i) const { return dt[i * dt_step]; }
};

struct Nominal {
    Vec3 p, v, ba, bg;
    Quat q;
};

// eskf_predict's nominal half for sample i: writes the blocks of F_i that
// differ from I15 into F (its other entries stay as set once) and steps s.
__device__ void nominal_step(Nominal& s, const Window& win, int i, float gravity,
                             float F[D][D]) {
    const int j = i + 1 < win.n ? i + 1 : i;
    const Vec3 g0 = win.g(i), g1 = win.g(j), a0 = win.a(i), a1 = win.a(j);
    const float dt = win.step(i);
    const Vec3 w_mid = vsub(vscale(0.5f, vadd(g0, g1)), s.bg);
    const Vec3 w_dt = vscale(dt, w_mid);
    const Quat q_full = qmul(s.q, exp_quat(w_dt));
    const Vec3 a0_n = rotate(s.q, vsub(a0, s.ba));
    const Vec3 a1_n = rotate(q_full, vsub(a1, s.ba));
    Vec3 a_mid = vscale(0.5f, vadd(a0_n, a1_n));
    a_mid.z = sub(a_mid.z, gravity);
    const Vec3 half_a_dt2 = vscale(dt, vscale(dt, vscale(0.5f, a_mid)));
    const Vec3 p = vadd(vadd(s.p, vscale(dt, s.v)), half_a_dt2);
    const Vec3 v = vadd(s.v, vscale(dt, a_mid));

    float R[3][3], Sa[3][3], Sw[3][3];
    to_matrix(s.q, R);
    skew(vsub(vscale(0.5f, vadd(a0, a1)), s.ba), Sa);
    skew(w_dt, Sw);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float eye = r == c ? 1.0f : 0.0f;
            float rs = 0.0f;  // (−R skew(a_b))[r][c]
#pragma unroll
            for (int k = 0; k < 3; ++k) rs = add(rs, mul(-R[r][k], Sa[k][c]));
            F[P0 + r][V0 + c] = mul(eye, dt);
            F[V0 + r][TH0 + c] = mul(rs, dt);
            F[V0 + r][BA0 + c] = mul(-R[r][c], dt);
            F[TH0 + r][TH0 + c] = sub(eye, Sw[r][c]);
            F[TH0 + r][BG0 + c] = mul(-eye, dt);
        }
    }
    s.p = p;
    s.v = v;
    s.q = normalize(q_full);
}

struct Rates {
    float r[5];  // of [δp δv δθ δba δbg], each for its 3-block
};

__global__ void __launch_bounds__(THREADS)
eskf_propagate_kernel(const float* __restrict__ p0, const float* __restrict__ v0,
                      const float* __restrict__ q0, const float* __restrict__ ba,
                      const float* __restrict__ bg, const float* __restrict__ cov0,
                      Window win, Rates rates, float gravity,
                      float* __restrict__ p_out, float* __restrict__ v_out,
                      float* __restrict__ q_out, float* __restrict__ ba_out,
                      float* __restrict__ bg_out, float* __restrict__ cov_out) {
    __shared__ float P[D][D], T[D][D], F[D][D];
    const int t = threadIdx.x;
    const int r = t / D, c = t % D;

    Nominal s;
    if (t == 0) {
        s.p = {p0[0], p0[1], p0[2]};
        s.v = {v0[0], v0[1], v0[2]};
        s.q = {q0[0], q0[1], q0[2], q0[3]};
        s.ba = {ba[0], ba[1], ba[2]};
        s.bg = {bg[0], bg[1], bg[2]};
    }
    F[r][c] = r == c ? 1.0f : 0.0f;
    P[r][c] = cov0[t];
    __syncthreads();

    for (int i = 0; i < win.n; ++i) {
        if (t == 0) nominal_step(s, win, i, gravity, F);
        __syncthreads();
        float x = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) x = fmaf(F[r][k], P[k][c], x);
        T[r][c] = x;
        __syncthreads();
        x = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) x = fmaf(T[r][k], F[c][k], x);
        P[r][c] = add(x, r == c ? mul(rates.r[r / 3], win.step(i)) : 0.0f);
        __syncthreads();
    }

    cov_out[t] = P[r][c];
    if (t == 0) {
        p_out[0] = s.p.x; p_out[1] = s.p.y; p_out[2] = s.p.z;
        v_out[0] = s.v.x; v_out[1] = s.v.y; v_out[2] = s.v.z;
        q_out[0] = s.q.w; q_out[1] = s.q.x; q_out[2] = s.q.y; q_out[3] = s.q.z;
        ba_out[0] = s.ba.x; ba_out[1] = s.ba.y; ba_out[2] = s.ba.z;
        bg_out[0] = s.bg.x; bg_out[1] = s.bg.y; bg_out[2] = s.bg.z;
    }
}

}  // namespace

// state: p (3), v (3), q (4), ba (3), bg (3), cov (15x15), float32,
// contiguous; gyro and acc: (n, 3) float32 with the given row and column
// strides, dt: (n,) float32 with the given stride (strides in elements);
// rates: the 5 process-noise densities of [δp δv δθ δba δbg]; the outputs
// as the state. Returns cudaGetLastError() after the launch.
extern "C" int eskf_propagate_launch(const void* p, const void* v, const void* q,
                                     const void* ba, const void* bg, const void* cov,
                                     const void* gyro, int64_t gyro_row, int64_t gyro_col,
                                     const void* acc, int64_t acc_row, int64_t acc_col,
                                     const void* dt, int64_t dt_step, int n,
                                     float rate_p, float rate_v, float rate_th, float rate_ba,
                                     float rate_bg, float gravity, void* p_out, void* v_out,
                                     void* q_out, void* ba_out, void* bg_out, void* cov_out,
                                     void* stream) {
    if (n <= 0) return -1;
    const Window win{static_cast<const float*>(gyro), static_cast<const float*>(acc),
                     static_cast<const float*>(dt), gyro_row, gyro_col, acc_row, acc_col,
                     dt_step, n};
    const Rates rates{{rate_p, rate_v, rate_th, rate_ba, rate_bg}};
    eskf_propagate_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(v),
        static_cast<const float*>(q), static_cast<const float*>(ba),
        static_cast<const float*>(bg), static_cast<const float*>(cov), win, rates, gravity,
        static_cast<float*>(p_out), static_cast<float*>(v_out), static_cast<float*>(q_out),
        static_cast<float*>(ba_out), static_cast<float*>(bg_out),
        static_cast<float*>(cov_out));
    return static_cast<int>(cudaGetLastError());
}
