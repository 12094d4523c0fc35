// Exact k-nearest-neighbour search of each query in a masked reference cloud,
// for Hopper (sm_90a): two kernels, knn_partial_kernel and knn_merge_kernel.
//
// Replaces the TPU kernel lmsf_slam_tpu/ops/pallas_knn.py::_knn_kernel
// (launched by knn_pallas, pallas_knn.py:107) together with its wrapper's
// tail. The function computed is the whole of knn_pallas / neighbors.knn:
// for each query the k nearest VALID references, exact squared distances
// ascending, ties to the lowest reference index, 3.4e38 and index 0 where a
// slot has no valid neighbour or the query is masked. The Python wrapper
// (lmsf_slam_tpu_torch/ops/knn.py) allocates outputs and scratch and launches;
// nothing runs after the kernels.
//
// What bounds it on this card. At the largest association of a frame, 1536
// queries x 16384 references, the work is ~25 M pair distances x 8 FP32
// operations ~= 0.2 GFLOP: ~3 us at the H100's 67 TFLOP/s FP32 rate, and
// under 0.3 MB of traffic (~0.1 us at 3.35 TB/s). Neither operations nor
// bytes bound it: serial depth and an empty card do. A design with one thread
// a query and one block per 128 queries ran 12 blocks on 132 SMs and 16384
// dependent compare-and-insert steps a thread; it took 0.614 ms at that shape
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py).
//
// What the design does about it.
//  1. The references are split across blocks. Grid (ceil(Q / TQ), S): block
//     (x, y) scans reference slice y — slice_len points, a multiple of 16,
//     the ragged end masked — for query tile x and writes a sorted partial
//     list to scratch (Q, S, K). S is a function of (Q, N) alone, chosen by
//     the wrapper so that the grid has at least two blocks an SM.
//  2. L lanes of one warp (4 or 8) serve one query. Lane l scans entries
//     t = l (mod L) of the staged tile with a private sorted top-K in
//     registers; the L lists are merged with a shuffle butterfly at the end
//     of the slice. The tile lies in shared memory as float4 (x, y, z,
//     valid): the lanes of a group read L consecutive 16-byte words and the
//     groups of a warp read the same words, so a warp's load is one
//     conflict-free wavefront.
//  3. Loads stay off the critical path: the raw (n, 3) float and (n,) byte
//     ranges of the next tile arrive by cp.async in a two-stage ring while
//     the current tile is scanned; the float4 packing is a shared-to-shared
//     pass of TILE / THREADS points a thread.
//  4. A second kernel merges the S partial lists of each query and writes the
//     final outputs: distances ascending, 3.4e38 / index 0 for empty slots,
//     the query mask applied, and (optionally) the neighbours' coordinates,
//     so the caller needs no gather. A second launch was chosen over "the
//     last block to finish merges" because an atomic ticket is device state
//     that outlives the launch (it must be zeroed, or reset by the kernel,
//     and a replayed CUDA graph would depend on it) and needs a
//     __threadfence protocol; the launch costs a few microseconds on the
//     stream and keeps both kernels free of state. With S == 1 the first
//     kernel writes the final outputs itself and the merge is not launched.
//  5. Every comparison is lexicographic on (distance, index): explicitly in
//     both merges, and in the scan's insert by construction (a lane meets
//     its candidates in ascending index, so '<' on the distance is that
//     order). Indices are unique, so the order is total and the result does
//     not depend on S or L: it is the result of one ascending scan with a
//     strict '<'.
//
// Arithmetic: true FP32, no tensor cores. The distance is (q - p)^2 summed as
// (dx*dx + dy*dy) + dz*dz with __fmul_rn / __fadd_rn, so the compiler cannot
// contract it into FMAs and the value is the same on every path (and equal,
// bit for bit, to the elementwise torch expression of the plain model). The
// expansion |q|^2 + |p|^2 - 2 q.p is not used: it cancels at long range. TF32
// is not used: its 10-bit mantissa cannot rank neighbours that lie
// centimetres apart at 30 m range, and the reference pins float32 geometry.
// The contraction depth is 3 and the whole problem is ~3 us of FP32 FMA
// rate, so wgmma has nothing to offer here; what the card offers this kernel
// is 132 SMs, shared memory, asynchronous copies and warp shuffles.
//
// Neither kernel allocates, synchronises with the host or has a launch shape
// that depends on data, so a sequence of calls can be captured in a CUDA
// graph.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; CUDA events, scan and
// merge together, launches queued back to back): 0.0171 ms at 384 x 8192 k=5
// (S=22, 264 blocks), 0.0529 ms at 1536 x 16384 k=5 (S=8, 384 blocks; the
// one-thread-a-query design: 0.3175 and 0.6139 ms) and 0.0372 ms at
// 1920 x 24576 k=1 (S=12, 720 blocks); the merge alone 0.0042 ms; an empty
// launch 0.0018 ms; torch.cdist + topk 0.22, 0.83 and 1.39 ms. At most 48
// registers a thread, 21504 bytes of shared memory a block, no spills. What
// is left above the 0.0021 ms bound at 1536 x 16384: the insert path, which a
// warp runs whenever any of its 32 lists takes a candidate (~60 % of the scan
// there, going by the k=1 shape's rate per pair), and shared-memory
// bandwidth, since a 16-byte load is served a quarter-warp at a time and each
// loaded reference feeds one distance a lane (the k=1 shape, which hardly
// inserts, runs at ~21 scheduler slots a warp step).

#include <cuda_runtime.h>
#include <stdint.h>

#define KNN_THREADS 256      // threads a block, both kernels
#define KNN_TILE 512         // reference points staged at a time
#define KNN_MERGE_LANES 8    // lanes a query in the merge kernel
#define KNN_ALIGN 16         // slice starts are multiples of this many points
#define KNN_INF 3.4e38f

#define KNN_XYZ_CHUNKS (KNN_TILE * 12 / 16)  // 16-byte chunks of a raw xyz tile
#define KNN_MASK_CHUNKS (KNN_TILE / 16)      // 16-byte chunks of a raw mask tile

// (d1, i1) before (d2, i2): by distance, then by reference index.
__device__ __forceinline__ bool lex_less(float d1, int i1, float d2, int i2) {
    return d1 < d2 || (d1 == d2 && i1 < i2);
}

template <int K>
__device__ __forceinline__ void list_init(float (&bd)[K], int (&bi)[K]) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
        bd[j] = KNN_INF;
        bi[j] = 0;
    }
}

// Sorted insert of (d, idx), from anywhere, into an ascending list, dropping
// the worst: the merges' insert, ordered by (distance, index). All
// indexing is static so the list stays in registers. An empty slot is
// (INF, 0); a real candidate always has d < INF, so it goes before every
// empty slot, and an empty slot offered as a candidate is never inserted.
template <int K>
__device__ __forceinline__ void list_insert(float (&bd)[K], int (&bi)[K],
                                            float d, int idx) {
    if (lex_less(d, idx, bd[K - 1], bi[K - 1])) {
#pragma unroll
        for (int j = K - 1; j > 0; --j) {
            const bool shift = lex_less(d, idx, bd[j - 1], bi[j - 1]);
            const bool here = !shift && lex_less(d, idx, bd[j], bi[j]);
            bd[j] = shift ? bd[j - 1] : (here ? d : bd[j]);
            bi[j] = shift ? bi[j - 1] : (here ? idx : bi[j]);
        }
        if (lex_less(d, idx, bd[0], bi[0])) {
            bd[0] = d;
            bi[0] = idx;
        }
    }
}

// The scan's insert: the candidate takes the last slot and bubbles up past
// every strictly greater distance. Within one lane's scan the indices only
// grow, so a candidate that ties a kept distance has the higher index and
// stays behind it: plain '<' on the distance IS the lexicographic order here,
// at one comparison and four selects a slot. (A warp runs this path whenever
// any of its 32 lists takes a candidate, which early in a slice is almost
// every step, so its length is what the scan costs.)
template <int K>
__device__ __forceinline__ void list_push_ascending(float (&bd)[K], int (&bi)[K],
                                                    float d, int idx) {
    bd[K - 1] = d;
    bi[K - 1] = idx;
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
        const bool up = bd[j] < bd[j - 1];
        const float td = bd[j - 1];
        const int ti = bi[j - 1];
        bd[j - 1] = up ? bd[j] : td;
        bi[j - 1] = up ? bi[j] : ti;
        bd[j] = up ? td : bd[j];
        bi[j] = up ? ti : bi[j];
    }
}

// Butterfly over the L lanes of a group (L consecutive lanes of a warp, L a
// power of two): after it every lane holds the best K of the group's L
// disjoint lists. Every lane of the warp must call it.
template <int K, int L>
__device__ __forceinline__ void group_merge(float (&bd)[K], int (&bi)[K]) {
#pragma unroll
    for (int o = 1; o < L; o <<= 1) {
        float od[K];
        int oi[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
            od[j] = __shfl_xor_sync(0xffffffffu, bd[j], o);
            oi[j] = __shfl_xor_sync(0xffffffffu, bi[j], o);
        }
#pragma unroll
        for (int j = 0; j < K; ++j) list_insert<K>(bd, bi, od[j], oi[j]);
    }
}

// Final outputs of slot j of query qi: INF / index 0 for an empty slot or a
// masked query, and the neighbour's coordinates where asked for (those of
// reference 0 for an empty slot, as a gather with index 0 gives).
__device__ __forceinline__ void emit(float d, int idx, bool query_ok, int slot,
                                     const float* __restrict__ rxyz,
                                     float* __restrict__ out_d,
                                     int32_t* __restrict__ out_i,
                                     float* __restrict__ out_nbr) {
    const bool has = query_ok && d < KNN_INF;
    const int i = has ? idx : 0;
    out_d[slot] = has ? d : KNN_INF;
    out_i[slot] = i;
    if (out_nbr != nullptr) {
        out_nbr[3 * slot + 0] = rxyz[3 * i + 0];
        out_nbr[3 * slot + 1] = rxyz[3 * i + 1];
        out_nbr[3 * slot + 2] = rxyz[3 * i + 2];
    }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of n raw points (1..KNN_TILE) into one stage of the ring.
// gx and gm are 16-byte aligned (the wrapper aligns the tensors, slices and
// tiles start at multiples of 16 points). Whole 16-byte chunks go by
// cp.async; the one ragged chunk at the end of each range is copied by hand
// and zero-padded, so nothing is read past the n-th point.
__device__ __forceinline__ void stage_tile(float* sx, uint8_t* sm,
                                           const float* __restrict__ gx,
                                           const uint8_t* __restrict__ gm,
                                           int n, int tid) {
    for (int c = tid; c < KNN_XYZ_CHUNKS + KNN_MASK_CHUNKS; c += KNN_THREADS) {
        if (c < KNN_XYZ_CHUNKS) {
            const int rem = 12 * n - 16 * c;  // bytes left, a multiple of 4
            if (rem >= 16) {
                cp_async16(sx + 4 * c, gx + 4 * c);
            } else if (rem > 0) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    sx[4 * c + e] = (4 * e < rem) ? gx[4 * c + e] : 0.f;
            }
        } else {
            const int m = c - KNN_XYZ_CHUNKS;
            const int rem = n - 16 * m;  // mask bytes left
            if (rem >= 16) {
                cp_async16(sm + 16 * m, gm + 16 * m);
            } else if (rem > 0) {
#pragma unroll
                for (int e = 0; e < 16; ++e)
                    sm[16 * m + e] = (e < rem) ? gm[16 * m + e] : uint8_t(0);
            }
        }
    }
}

// Block (x, y): the best K of reference slice y for the KNN_THREADS / L
// queries of tile x. With S == 1 it writes the final outputs, else a sorted
// partial list to part_d / part_i at [(qi * S + y) * K].
template <int K, int L>
__global__ void __launch_bounds__(KNN_THREADS)
knn_partial_kernel(const float* __restrict__ qxyz,     // (Q, 3)
                   const uint8_t* __restrict__ qmask,  // (Q,)
                   const float* __restrict__ rxyz,     // (N, 3)
                   const uint8_t* __restrict__ rmask,  // (N,)
                   int Q, int N, int S, int slice_len,
                   float* __restrict__ part_d,         // (Q, S, K), S > 1
                   int32_t* __restrict__ part_i,       // (Q, S, K), S > 1
                   float* __restrict__ out_d,          // (Q, K), S == 1
                   int32_t* __restrict__ out_i,        // (Q, K), S == 1
                   float* __restrict__ out_nbr)        // (Q, K, 3) or null
{
    __shared__ __align__(16) float raw_xyz[2][KNN_TILE * 3];
    __shared__ __align__(16) uint8_t raw_mask[2][KNN_TILE];
    __shared__ float4 tile[KNN_TILE];

    const int tid = threadIdx.x;
    const int lane = tid % L;
    const int qi = blockIdx.x * (KNN_THREADS / L) + tid / L;
    const int s = blockIdx.y;
    const int begin = min(N, s * slice_len);
    const int n_slice = min(N, begin + slice_len) - begin;
    const int n_tiles = (n_slice + KNN_TILE - 1) / KNN_TILE;

    // a query past the end still takes part in the shuffles; it is masked at
    // the write
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (qi < Q) {
        qx = qxyz[3 * qi + 0];
        qy = qxyz[3 * qi + 1];
        qz = qxyz[3 * qi + 2];
    }
    float bd[K];
    int bi[K];
    list_init<K>(bd, bi);

    if (n_tiles > 0)
        stage_tile(raw_xyz[0], raw_mask[0], rxyz + 3 * begin, rmask + begin,
                   min(KNN_TILE, n_slice), tid);
    cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
        const int base = begin + it * KNN_TILE;
        const int n_t = min(KNN_TILE, n_slice - it * KNN_TILE);
        if (it + 1 < n_tiles) {
            // stage (it + 1) & 1 was packed in the previous iteration, before
            // its second barrier
            const int nb = base + KNN_TILE;
            stage_tile(raw_xyz[(it + 1) & 1], raw_mask[(it + 1) & 1],
                       rxyz + 3 * nb, rmask + nb,
                       min(KNN_TILE, n_slice - (it + 1) * KNN_TILE), tid);
        }
        cp_async_commit();   // one group an iteration, empty at the last
        cp_async_wait<1>();  // this thread's copies of tile `it` have landed
        __syncthreads();     // everyone's have; the previous scan is over
        const float* rx = raw_xyz[it & 1];
        const uint8_t* rm = raw_mask[it & 1];
        for (int t = tid; t < n_t; t += KNN_THREADS)
            tile[t] = make_float4(rx[3 * t + 0], rx[3 * t + 1], rx[3 * t + 2],
                                  rm[t] ? 1.f : 0.f);
        __syncthreads();
#pragma unroll 4
        for (int t = lane; t < n_t; t += L) {
            const float4 p = tile[t];
            const float dx = qx - p.x, dy = qy - p.y, dz = qz - p.z;
            const float d = __fadd_rn(
                __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
            if (p.w != 0.f && d < bd[K - 1]) list_push_ascending<K>(bd, bi, d, base + t);
        }
    }
    cp_async_wait<0>();

    group_merge<K, L>(bd, bi);

    if (qi < Q) {
        const bool final_pass = (S == 1);
        const bool query_ok = final_pass ? (qmask[qi] != 0) : true;
        // every lane of the group holds the list: lane l writes slots
        // j = l (mod L)
#pragma unroll
        for (int j = 0; j < K; ++j) {
            if (j % L == lane) {
                if (final_pass) {
                    emit(bd[j], bi[j], query_ok, qi * K + j, rxyz, out_d, out_i,
                         out_nbr);
                } else {
                    const int o = (qi * S + s) * K + j;
                    part_d[o] = bd[j];
                    part_i[o] = bi[j];
                }
            }
        }
    }
}

// The S sorted partial lists of each query merged into the final outputs.
// KNN_MERGE_LANES lanes a query: lane l takes lists s = l (mod lanes).
template <int K>
__global__ void __launch_bounds__(KNN_THREADS)
knn_merge_kernel(const float* __restrict__ part_d,    // (Q, S, K)
                 const int32_t* __restrict__ part_i,  // (Q, S, K)
                 const uint8_t* __restrict__ qmask,   // (Q,)
                 const float* __restrict__ rxyz,      // (N, 3)
                 int Q, int S,
                 float* __restrict__ out_d,           // (Q, K)
                 int32_t* __restrict__ out_i,         // (Q, K)
                 float* __restrict__ out_nbr)         // (Q, K, 3) or null
{
    constexpr int L = KNN_MERGE_LANES;
    const int tid = threadIdx.x;
    const int lane = tid % L;
    const int qi = blockIdx.x * (KNN_THREADS / L) + tid / L;
    float bd[K];
    int bi[K];
    list_init<K>(bd, bi);
    if (qi < Q) {
        for (int s = lane; s < S; s += L) {
            const int o = (qi * S + s) * K;
#pragma unroll
            for (int j = 0; j < K; ++j)
                list_insert<K>(bd, bi, part_d[o + j], part_i[o + j]);
        }
    }
    group_merge<K, L>(bd, bi);
    if (qi < Q) {
        const bool query_ok = qmask[qi] != 0;
#pragma unroll
        for (int j = 0; j < K; ++j)
            if (j % L == lane)
                emit(bd[j], bi[j], query_ok, qi * K + j, rxyz, out_d, out_i, out_nbr);
    }
}

__global__ void knn_empty_kernel() {}

struct PartialArgs {
    const float* q;
    const uint8_t* qm;
    const float* r;
    const uint8_t* rm;
    int Q, N, S, slice_len;
    float* pd;
    int32_t* pi;
    float* od;
    int32_t* oi;
    float* nbr;
    cudaStream_t st;
};

template <int K, int L>
static void launch_partial_kl(const PartialArgs& a) {
    const int tq = KNN_THREADS / L;
    const dim3 grid((a.Q + tq - 1) / tq, a.S);
    knn_partial_kernel<K, L><<<grid, KNN_THREADS, 0, a.st>>>(
        a.q, a.qm, a.r, a.rm, a.Q, a.N, a.S, a.slice_len, a.pd, a.pi, a.od, a.oi,
        a.nbr);
}

template <int K>
static void launch_partial_k(const PartialArgs& a, int lanes) {
    if (lanes == 4)
        launch_partial_kl<K, 4>(a);
    else
        launch_partial_kl<K, 8>(a);
}

// The constants the wrapper mirrors (it checks them when the library loads).
extern "C" int knn_threads() { return KNN_THREADS; }
extern "C" int knn_tile() { return KNN_TILE; }
extern "C" int knn_align() { return KNN_ALIGN; }
extern "C" int knn_merge_lanes() { return KNN_MERGE_LANES; }

// Each entry returns cudaGetLastError() after its launch (0 = launched), or
// -1 for arguments the kernels do not take (the wrapper never passes them).

extern "C" int knn_partial_launch(const void* query_xyz, const void* query_mask,
                                  const void* ref_xyz, const void* ref_mask,
                                  int Q, int N, int k, int splits, int lanes,
                                  int slice_len, void* part_d, void* part_i,
                                  void* out_d, void* out_i, void* out_nbr,
                                  void* stream) {
    if (Q <= 0 || N <= 0 || splits < 1 || splits > 65535) return -1;
    if (lanes != 4 && lanes != 8) return -1;
    if (slice_len <= 0 || slice_len % KNN_ALIGN != 0) return -1;
    if (static_cast<long long>(slice_len) * splits < N) return -1;
    const PartialArgs a = {
        static_cast<const float*>(query_xyz),
        static_cast<const uint8_t*>(query_mask),
        static_cast<const float*>(ref_xyz),
        static_cast<const uint8_t*>(ref_mask),
        Q, N, splits, slice_len,
        static_cast<float*>(part_d), static_cast<int32_t*>(part_i),
        static_cast<float*>(out_d), static_cast<int32_t*>(out_i),
        static_cast<float*>(out_nbr), static_cast<cudaStream_t>(stream)};
    switch (k) {
        case 1: launch_partial_k<1>(a, lanes); break;
        case 2: launch_partial_k<2>(a, lanes); break;
        case 3: launch_partial_k<3>(a, lanes); break;
        case 4: launch_partial_k<4>(a, lanes); break;
        case 5: launch_partial_k<5>(a, lanes); break;
        case 6: launch_partial_k<6>(a, lanes); break;
        case 7: launch_partial_k<7>(a, lanes); break;
        case 8: launch_partial_k<8>(a, lanes); break;
        default: return -1;
    }
    return static_cast<int>(cudaGetLastError());
}

template <int K>
static void launch_merge_k(const float* pd, const int32_t* pi, const uint8_t* qm,
                           const float* r, int Q, int S, float* od, int32_t* oi,
                           float* nbr, cudaStream_t st) {
    const int tq = KNN_THREADS / KNN_MERGE_LANES;
    knn_merge_kernel<K><<<(Q + tq - 1) / tq, KNN_THREADS, 0, st>>>(
        pd, pi, qm, r, Q, S, od, oi, nbr);
}

extern "C" int knn_merge_launch(const void* part_d, const void* part_i,
                                const void* query_mask, const void* ref_xyz,
                                int Q, int splits, int k, void* out_d,
                                void* out_i, void* out_nbr, void* stream) {
    if (Q <= 0 || splits < 1) return -1;
    const float* pd = static_cast<const float*>(part_d);
    const int32_t* pi = static_cast<const int32_t*>(part_i);
    const uint8_t* qm = static_cast<const uint8_t*>(query_mask);
    const float* r = static_cast<const float*>(ref_xyz);
    float* od = static_cast<float*>(out_d);
    int32_t* oi = static_cast<int32_t*>(out_i);
    float* nbr = static_cast<float*>(out_nbr);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (k) {
        case 1: launch_merge_k<1>(pd, pi, qm, r, Q, splits, od, oi, nbr, st); break;
        case 2: launch_merge_k<2>(pd, pi, qm, r, Q, splits, od, oi, nbr, st); break;
        case 3: launch_merge_k<3>(pd, pi, qm, r, Q, splits, od, oi, nbr, st); break;
        case 4: launch_merge_k<4>(pd, pi, qm, r, Q, splits, od, oi, nbr, st); break;
        case 5: launch_merge_k<5>(pd, pi, qm, r, Q, splits, od, oi, nbr, st); break;
        case 6: launch_merge_k<6>(pd, pi, qm, r, Q, splits, od, oi, nbr, st); break;
        case 7: launch_merge_k<7>(pd, pi, qm, r, Q, splits, od, oi, nbr, st); break;
        case 8: launch_merge_k<8>(pd, pi, qm, r, Q, splits, od, oi, nbr, st); break;
        default: return -1;
    }
    return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the stream: what one launch costs on this card, the
// practical floor beside the arithmetic bound.
extern "C" int knn_empty_launch(void* stream) {
    knn_empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
