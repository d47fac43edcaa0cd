// Weighted federated aggregation for Hopper (sm_90a).
//
//   eff_c = w_c * alpha_c, rows with eff_c <= 0 (NaN included) dropped,
//   eff  /= max(sum eff, 1e-30)            (all-zero weights -> zeros)
//   out[p] = sum_c eff_c * u[c][p]         (f32 accumulate, row order)
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedagg.py: _kernel /
// fedagg.  That kernel holds an (N, block) panel in on-chip memory and
// makes one dot per grid step; here the grid runs over the parameter
// axis only, each thread owns one vector (4, 2 or 1) of consecutive
// columns, walks the N rows in order accumulating in registers, and
// writes its columns once.
//
// Bound: bytes.  Every live row element is read once and every output
// element written once, (N*P + P)*4 bytes against 2*N*P operations, far
// under the card's operations-per-byte balance.  So the design is about
// the stream: vector loads, neighbouring threads on neighbouring
// addresses, ROWS_IN_FLIGHT independent loads started before their
// multiply-adds, no shared-memory staging of the data and no second
// pass.  Shared memory holds only the weights (8 bytes a row), so eight
// blocks of 256 threads fit an SM.  A dropped row is skipped before its
// load, so inf/nan in it cannot reach the sum and its bytes are not
// moved.
//
// Order: the row loop is sequential and the normalisation is summed by
// one thread in row order, so every block derives the same bits and a
// result does not depend on the grid.  Rows of weight 0 add nothing to
// either sum: appending them leaves the output bitwise unchanged.
//
// A second entry, fedagg_fold_f32, is the async runtime's staleness
// window merge (replaces src/repro/kernels/fedagg.py: _fold_kernel /
// fedagg_fold):
//
//   c = coef > 0 ? coef : 0 over the (K+1,) coefficients, global first,
//   c /= max(sum c, 1e-30)                 (all-zero -> zeros)
//   out[p] = (c0 > 0 ? c0 * g[p] : 0) + sum_k c_k * u[k][p]
//
// It is the same stream with the global model's row as an implicit row
// 0 (never copied into the (K, P) buffer) and the same row loop; only
// the preamble that derives the coefficients differs.  The global
// term is kept apart from the row sum until the end and both are
// rounded on their own (no contraction into the row sum's last fma),
// as the reference adds them.  Bound: bytes, (K_live*P + 2P)*4.
//
// A third entry, fedagg_partial_f32, is the per-shard term of the client
// mesh's reductions (replaces src/repro/kernels/fedagg.py:
// _partial_kernel / fedagg_partial):
//
//   c = coef > 0 ? coef : 0 over the (R,) coefficients (NaN -> 0),
//   out[p] = sum_r c_r * u[r][p]           (no normalisation)
//
// The caller adds the shards' outputs and divides by the sum of all
// shards' coefficients.  Same stream and row loop again; the preamble
// only masks the coefficients and packs the live rows, so a masked row
// is never loaded and all-zero coefficients give exact zeros.  Bound:
// bytes, (R_live*P + P)*4.
//
// Past FEDAGG_MAX_ROWS (4096) rows the coefficients no longer fit one
// block's shared memory, and each of the three entries has a tiled twin
// (fedagg_f32_ws, fedagg_fold_f32_ws, fedagg_partial_f32_ws) of two
// launches on the caller's stream and no host sync (the wrappers also
// send it tall calls under that cap, from 128 or 256 rows on:
// kernels/fedagg.py: tiled_route):
//
//   * a preamble of one block derives the coefficients with the same
//     arithmetic in the same order as the single launch's: effective
//     weights masked where <= 0 (NaN included), the total summed by one
//     thread in row order (from shared memory, a chunk at a time), the
//     division, and the live rows packed in row order (a block scan).
//     It writes the packed coefficients, their row indices, the live
//     count and (K2) the global row's coefficient into a device
//     workspace the caller allocates (fedagg_ws_floats(n) floats);
//   * the stream kernel folds the live rows into its columns in their
//     packed order, the f32 accumulator in registers: the same
//     sequential fma chain as the single launch, so the bits are the
//     same and appended rows of coefficient 0 change none of them.  K2's
//     global row is kept apart until the end, as above.  Masked rows
//     are never loaded.
//
// The stream is bound by bytes, and at the widths of the paper's
// cross-device models a row is short: resnet8-cifar10's tree of 77,594
// floats is 310 KB, 2.4 KB an SM.  Bytes in flight then decide the rate (the
// card's 3.35 TB/s times a loaded latency of a microsecond or two is
// several MB, tens of KB an SM), and a thread owns only one vector of
// columns, so its rows have to stay in flight back to back:
//   * a ring of rows a thread in registers (FedaggRing: 32 float4s, 64
//     of a narrower vector): the thread folds the oldest row and at once
//     starts the load of the row a ring ahead into its slot, so a ring's
//     worth of loads is always in flight, with no gap between batches
//     and no block barrier;
//   * the packed coefficients and row indices ride with it, a chunk of
//     32 in a warp's lanes (one coalesced load each, a ring ahead of
//     their use) and broadcast to the warp by shuffles: no shared memory;
//   * blocks as narrow as P asks (ws_grid): the columns cut into k
//     blocks an SM of whole warps, so that every SM gets columns where
//     the row is short and no second wave of a few blocks trails the
//     first; past what is resident a block grid-strides.  Each SM then
//     keeps (ring x threads x vector) bytes in flight: 128 KB at 131,072
//     columns (float4, 256 threads), about 160 KB at resnet8-cifar10's
//     77,594 (float2, two blocks of 160).
// tools/fedagg_variants.py times the ring's depth and the block width
// against the first design (tiles of 2,048 coefficients staged in shared
// memory behind two block barriers, 16 rows a thread in flight a batch).
//
// The row index is an int: FEDAGG_WS_MAX_ROWS = 2^30 keeps every index,
// count and workspace offset inside it.

#include <cuda_runtime.h>

#define FEDAGG_MAX_ROWS 4096     // 8 bytes of shared memory a row: 32 KB
#define FEDAGG_THREADS 256
#define ROWS_IN_FLIGHT 16
#define BLOCKS_PER_SM 8          // 2048 threads of an SM in 256s

extern "C" int fedagg_max_rows() { return FEDAGG_MAX_ROWS; }

// The weights' scratch: n floats (normalised effective weights) then n
// ints (indices of the live rows), sized by the launch.
extern __shared__ float fedagg_smem[];

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float2 ldg(const float2* p) { return __ldg(p); }
__device__ __forceinline__ float4 ldg(const float4* p) { return __ldg(p); }

__device__ __forceinline__ void fma_into(float e, float x, float& acc) {
    acc = fmaf(e, x, acc);
}
__device__ __forceinline__ void fma_into(float e, float2 x, float2& acc) {
    acc.x = fmaf(e, x.x, acc.x);
    acc.y = fmaf(e, x.y, acc.y);
}
__device__ __forceinline__ void fma_into(float e, float4 x, float4& acc) {
    acc.x = fmaf(e, x.x, acc.x);
    acc.y = fmaf(e, x.y, acc.y);
    acc.z = fmaf(e, x.z, acc.z);
    acc.w = fmaf(e, x.w, acc.w);
}

// Normalised effective weights into eff[], and the indices of the live
// rows packed to the front of live[] so the row loop neither loads nor
// branches on a dropped row.  Returns the live count.
__device__ int effective_weights(const float* __restrict__ w,
                                 const float* __restrict__ a, int n,
                                 float* eff, int* live) {
    __shared__ int n_live;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float e = a ? w[i] * a[i] : w[i];   // no alphas: all ones
        eff[i] = e > 0.0f ? e : 0.0f;             // NaN compares false
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float total = 0.0f;
        int k = 0;
        for (int i = 0; i < n; ++i) {          // one fixed order
            total += eff[i];
            if (eff[i] > 0.0f) live[k++] = i;
        }
        total = fmaxf(total, 1e-30f);
        for (int j = 0; j < k; ++j) eff[live[j]] /= total;
        n_live = k;
    }
    __syncthreads();
    return n_live;
}

// R rows of this thread's columns (one vector V of them): all R loads
// are started before the first multiply-add, and the adds keep the row
// order.
template <typename V, int R>
__device__ __forceinline__ void add_rows(const float* __restrict__ u,
                                         long long p, long long col,
                                         int n, int j, V& acc) {
    const float* eff = fedagg_smem;
    const int* live = reinterpret_cast<const int*>(fedagg_smem + n);
    V x[R];
    float e[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int row = live[j + r];
        e[r] = eff[row];
        x[r] = ldg(reinterpret_cast<const V*>(u + (long long)row * p + col));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) fma_into(e[r], x[r], acc);
}

// This thread's columns summed over the n_live live rows, in row order:
// ROWS_IN_FLIGHT rows at a time, then 4, then 1.
template <typename V>
__device__ __forceinline__ V sum_live_rows(const float* __restrict__ u,
                                           long long p, long long col,
                                           int n, int n_live) {
    V acc = V();
    int j = 0;
    for (; j + ROWS_IN_FLIGHT <= n_live; j += ROWS_IN_FLIGHT)
        add_rows<V, ROWS_IN_FLIGHT>(u, p, col, n, j, acc);
    for (; j + 4 <= n_live; j += 4)
        add_rows<V, 4>(u, p, col, n, j, acc);
    for (; j < n_live; ++j)
        add_rows<V, 1>(u, p, col, n, j, acc);
    return acc;
}

template <typename V>
__global__ void __launch_bounds__(FEDAGG_THREADS)
fedagg_kernel(const float* __restrict__ u, const float* __restrict__ w,
              const float* __restrict__ a, float* __restrict__ out,
              int n, long long p) {
    constexpr int VEC = sizeof(V) / sizeof(float);
    const int n_live = effective_weights(
        w, a, n, fedagg_smem, reinterpret_cast<int*>(fedagg_smem + n));

    // Grid-stride over the columns: a block derives the weights once
    // and then streams many tiles.  p is a multiple of VEC (the
    // caller's contract), so a thread that starts inside the row owns
    // VEC whole columns: no ragged tail.
    const long long step = (long long)gridDim.x * blockDim.x * VEC;
    for (long long col =
             ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
         col < p; col += step) {
        *reinterpret_cast<V*>(out + col) =
            sum_live_rows<V>(u, p, col, n, n_live);
    }
}

// Blocks for p columns in vectors V: enough to cover the row, at most
// what is resident on the card at once (the kernels grid-stride).
template <typename V>
static int grid_blocks(long long p, unsigned* blocks) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const long long per_block =
        (long long)FEDAGG_THREADS * (sizeof(V) / sizeof(float));
    long long b = (p + per_block - 1) / per_block;
    const long long resident = (long long)sms * BLOCKS_PER_SM;
    *blocks = (unsigned)(b > resident ? resident : b);
    return 0;
}

template <typename V>
static int launch(const float* u, const float* w, const float* a, float* out,
                  int n, long long p, cudaStream_t stream) {
    unsigned blocks = 0;
    const int err = grid_blocks<V>(p, &blocks);
    if (err != 0) return err;
    const size_t smem = (size_t)n * (sizeof(float) + sizeof(int));
    fedagg_kernel<V><<<blocks, FEDAGG_THREADS, smem, stream>>>(
        u, w, a, out, n, p);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// fedagg_fold: the staleness window merge, global row as implicit row 0
// ---------------------------------------------------------------------

// Masked, normalised coefficients: c0 into *c0, the k row coefficients
// into eff[] and the indices of the rows with a positive normalised
// coefficient packed to the front of live[] (the layout add_rows
// reads).  One thread sums the k+1 coefficients in index order, so
// trailing zeros leave every bit of the result unchanged.  Returns the
// live count.
__device__ int fold_coefficients(const float* __restrict__ coef, int k,
                                 float* eff, int* live, float* c0) {
    __shared__ int n_live;
    for (int i = threadIdx.x; i <= k; i += blockDim.x) {
        const float c = coef[i];
        const float v = c > 0.0f ? c : 0.0f;      // NaN compares false
        if (i == 0) *c0 = v; else eff[i - 1] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float total = 0.0f;
        total += *c0;
        for (int i = 0; i < k; ++i) total += eff[i];   // one fixed order
        total = fmaxf(total, 1e-30f);
        *c0 = *c0 / total;
        int j = 0;
        for (int i = 0; i < k; ++i) {
            eff[i] = eff[i] / total;
            if (eff[i] > 0.0f) live[j++] = i;
        }
        n_live = j;
    }
    __syncthreads();
    return n_live;
}

// The global term and the final add, each rounded on its own.
__device__ __forceinline__ float global_plus(float c0, float g, float acc) {
    return __fadd_rn(__fmul_rn(c0, g), acc);
}
__device__ __forceinline__ float2 global_plus(float c0, float2 g,
                                              float2 acc) {
    return make_float2(global_plus(c0, g.x, acc.x),
                       global_plus(c0, g.y, acc.y));
}
__device__ __forceinline__ float4 global_plus(float c0, float4 g,
                                              float4 acc) {
    return make_float4(global_plus(c0, g.x, acc.x),
                       global_plus(c0, g.y, acc.y),
                       global_plus(c0, g.z, acc.z),
                       global_plus(c0, g.w, acc.w));
}

template <typename V>
__global__ void __launch_bounds__(FEDAGG_THREADS)
fedagg_fold_kernel(const float* __restrict__ u, const float* __restrict__ g,
                   const float* __restrict__ coef, float* __restrict__ out,
                   int k, long long p) {
    constexpr int VEC = sizeof(V) / sizeof(float);
    __shared__ float c0_shared;
    const int n_live = fold_coefficients(
        coef, k, fedagg_smem, reinterpret_cast<int*>(fedagg_smem + k),
        &c0_shared);
    const float c0 = c0_shared;

    const long long step = (long long)gridDim.x * blockDim.x * VEC;
    for (long long col =
             ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
         col < p; col += step) {
        V acc = sum_live_rows<V>(u, p, col, k, n_live);
        // c0 == 0: the global row is neither read nor multiplied, so
        // inf/nan in it cannot reach the output
        if (c0 > 0.0f)
            acc = global_plus(c0, ldg(reinterpret_cast<const V*>(g + col)),
                              acc);
        *reinterpret_cast<V*>(out + col) = acc;
    }
}

template <typename V>
static int launch_fold(const float* u, const float* g, const float* coef,
                       float* out, int k, long long p, cudaStream_t stream) {
    unsigned blocks = 0;
    const int err = grid_blocks<V>(p, &blocks);
    if (err != 0) return err;
    const size_t smem = (size_t)k * (sizeof(float) + sizeof(int));
    fedagg_fold_kernel<V><<<blocks, FEDAGG_THREADS, smem, stream>>>(
        u, g, coef, out, k, p);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// fedagg_partial: one shard's unnormalised masked row sum
// ---------------------------------------------------------------------

// Masked coefficients into eff[] and the indices of the rows with c > 0
// packed, in row order, to the front of live[] (the layout add_rows
// reads).  Nothing is normalised.  Returns the live count.
__device__ int partial_coefficients(const float* __restrict__ coef, int n,
                                    float* eff, int* live) {
    __shared__ int n_live;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float c = coef[i];
        eff[i] = c > 0.0f ? c : 0.0f;             // NaN compares false
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int k = 0;
        for (int i = 0; i < n; ++i)
            if (eff[i] > 0.0f) live[k++] = i;
        n_live = k;
    }
    __syncthreads();
    return n_live;
}

template <typename V>
__global__ void __launch_bounds__(FEDAGG_THREADS)
fedagg_partial_kernel(const float* __restrict__ u,
                      const float* __restrict__ coef,
                      float* __restrict__ out, int n, long long p) {
    constexpr int VEC = sizeof(V) / sizeof(float);
    const int n_live = partial_coefficients(
        coef, n, fedagg_smem, reinterpret_cast<int*>(fedagg_smem + n));

    const long long step = (long long)gridDim.x * blockDim.x * VEC;
    for (long long col =
             ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
         col < p; col += step)
        *reinterpret_cast<V*>(out + col) =
            sum_live_rows<V>(u, p, col, n, n_live);
}

template <typename V>
static int launch_partial(const float* u, const float* coef, float* out,
                          int n, long long p, cudaStream_t stream) {
    unsigned blocks = 0;
    const int err = grid_blocks<V>(p, &blocks);
    if (err != 0) return err;
    const size_t smem = (size_t)n * (sizeof(float) + sizeof(int));
    fedagg_partial_kernel<V><<<blocks, FEDAGG_THREADS, smem, stream>>>(
        u, coef, out, n, p);
    return (int)cudaGetLastError();
}

// updates (n, p) contiguous f32, weights (n,), alphas (n,) or null (all
// ones), out (p,), all on the current device.  `vec` (4, 2 or 1 floats)
// must divide p, and every row start u + r*p and out must be aligned to
// it; the caller derives it from the pointers and p.  Returns
// cudaGetLastError() after the launch; does not synchronise.
extern "C" int fedagg_f32(const void* u, const void* w, const void* a,
                          void* out, int n, long long p, int vec,
                          void* stream) {
    if (n < 1 || n > FEDAGG_MAX_ROWS || p < 1 || vec < 1 || p % vec != 0)
        return (int)cudaErrorInvalidValue;
    const float* uf = static_cast<const float*>(u);
    const float* wf = static_cast<const float*>(w);
    const float* af = static_cast<const float*>(a);
    float* of = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (vec) {
        case 4: return launch<float4>(uf, wf, af, of, n, p, s);
        case 2: return launch<float2>(uf, wf, af, of, n, p, s);
        case 1: return launch<float>(uf, wf, af, of, n, p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// updates (k, p) contiguous f32, global row g (p,), coefficients
// (k+1,) global first, out (p,), all on the current device.  `vec` as
// for fedagg_f32, with g aligned to it too.  Returns cudaGetLastError()
// after the launch; does not synchronise.
extern "C" int fedagg_fold_f32(const void* u, const void* g,
                               const void* coef, void* out, int k,
                               long long p, int vec, void* stream) {
    if (k < 1 || k + 1 > FEDAGG_MAX_ROWS || p < 1 || vec < 1 ||
        p % vec != 0)
        return (int)cudaErrorInvalidValue;
    const float* uf = static_cast<const float*>(u);
    const float* gf = static_cast<const float*>(g);
    const float* cf = static_cast<const float*>(coef);
    float* of = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (vec) {
        case 4: return launch_fold<float4>(uf, gf, cf, of, k, p, s);
        case 2: return launch_fold<float2>(uf, gf, cf, of, k, p, s);
        case 1: return launch_fold<float>(uf, gf, cf, of, k, p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// updates (n, p) contiguous f32, coefficients (n,), out (p,), all on the
// current device.  `vec` as for fedagg_f32.  Returns cudaGetLastError()
// after the launch; does not synchronise.
extern "C" int fedagg_partial_f32(const void* u, const void* coef, void* out,
                                  int n, long long p, int vec,
                                  void* stream) {
    if (n < 1 || n > FEDAGG_MAX_ROWS || p < 1 || vec < 1 || p % vec != 0)
        return (int)cudaErrorInvalidValue;
    const float* uf = static_cast<const float*>(u);
    const float* cf = static_cast<const float*>(coef);
    float* of = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (vec) {
        case 4: return launch_partial<float4>(uf, cf, of, n, p, s);
        case 2: return launch_partial<float2>(uf, cf, of, n, p, s);
        case 1: return launch_partial<float>(uf, cf, of, n, p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------
// Past FEDAGG_MAX_ROWS: a preamble launch and the tiled stream
// ---------------------------------------------------------------------

#define FEDAGG_WS_MAX_ROWS (1 << 30)   // int indices, counts and offsets
#define FEDAGG_PRE_THREADS 1024
#define FEDAGG_PRE_CHUNK 4096          // floats summed from shared memory

// the three entries' coefficient rules, by MODE
#define FEDAGG_AVG 0                   // fedagg: w * a, normalised
#define FEDAGG_FOLD 1                  // fedagg_fold: coef[1:], global first
#define FEDAGG_PARTIAL 2               // fedagg_partial: coef, unnormalised

extern "C" int fedagg_ws_max_rows() { return FEDAGG_WS_MAX_ROWS; }

// Floats of the workspace of n rows: the packed coefficients (n), their
// row indices (n ints), the live count (an int) and fedagg_fold's
// normalised global coefficient.
extern "C" long long fedagg_ws_floats(int n) { return 2LL * n + 2; }

// Row i's coefficient masked at <= 0 (NaN compares false), before any
// division: the products and selects of effective_weights,
// fold_coefficients and partial_coefficients.
template <int MODE>
__device__ __forceinline__ float ws_masked(const float* __restrict__ c,
                                           const float* __restrict__ a,
                                           int i) {
    float e;
    if (MODE == FEDAGG_AVG) e = a ? c[i] * a[i] : c[i];
    else if (MODE == FEDAGG_FOLD) e = c[i + 1];
    else e = c[i];
    return e > 0.0f ? e : 0.0f;
}

// One block.  The total is summed by one thread in row order (a chunk
// staged in shared memory at a time; fedagg_fold starts from the global
// coefficient), then the rows are taken in chunks of the block: each
// coefficient divided (or not) as its single-launch twin divides it,
// and the live ones packed in row order by a block scan (a ballot a
// warp) into ws.
template <int MODE>
__global__ void __launch_bounds__(FEDAGG_PRE_THREADS)
fedagg_preamble_kernel(const float* __restrict__ c,
                       const float* __restrict__ a, int n,
                       float* __restrict__ ws) {
    __shared__ float chunk[FEDAGG_PRE_CHUNK];
    __shared__ int warp_live[FEDAGG_PRE_THREADS / 32];
    __shared__ float total_s;
    __shared__ int packed_s;
    float* coef = ws;
    int* rows = reinterpret_cast<int*>(ws + n);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    float c0 = 0.0f;
    if (MODE == FEDAGG_FOLD) {
        const float g = c[0];
        c0 = g > 0.0f ? g : 0.0f;
    }
    float total = 1.0f;
    if (MODE != FEDAGG_PARTIAL) {
        float acc = 0.0f;
        if (MODE == FEDAGG_FOLD) acc += c0;
        for (int base = 0; base < n; base += FEDAGG_PRE_CHUNK) {
            const int m = min(FEDAGG_PRE_CHUNK, n - base);
            for (int i = tid; i < m; i += blockDim.x)
                chunk[i] = ws_masked<MODE>(c, a, base + i);
            __syncthreads();
            if (tid == 0)
                for (int i = 0; i < m; ++i) acc += chunk[i];   // row order
            __syncthreads();
        }
        if (tid == 0) total_s = fmaxf(acc, 1e-30f);
        __syncthreads();
        total = total_s;
    }
    if (tid == 0) packed_s = 0;
    __syncthreads();
    for (int base = 0; base < n; base += blockDim.x) {
        const int i = base + tid;
        float e = 0.0f;
        bool live = false;
        if (i < n) {
            const float m = ws_masked<MODE>(c, a, i);
            if (MODE == FEDAGG_AVG) {          // live before the division
                live = m > 0.0f;
                e = m / total;
            } else if (MODE == FEDAGG_FOLD) {  // live after it
                e = m / total;
                live = e > 0.0f;
            } else {
                live = m > 0.0f;
                e = m;
            }
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, live);
        if (lane == 0) warp_live[warp] = __popc(ballot);
        __syncthreads();
        int at = packed_s + __popc(ballot & ((1u << lane) - 1));
        for (int w = 0; w < warp; ++w) at += warp_live[w];
        if (live) {
            coef[at] = e;
            rows[at] = i;
        }
        __syncthreads();
        if (tid == 0)
            for (int w = 0; w < FEDAGG_PRE_THREADS / 32; ++w)
                packed_s += warp_live[w];
        __syncthreads();
    }
    if (tid == 0) {
        reinterpret_cast<int*>(ws)[2LL * n] = packed_s;
        ws[2LL * n + 1] = MODE == FEDAGG_FOLD ? c0 / total : 0.0f;
    }
}

// Rows a thread keeps in flight: a multiple of the 32 a warp's lanes
// hold the coefficients and indices of.  float4: 32 rows, 128 registers
// of data; narrower vectors hold twice as many rows in as many registers
// or fewer (a short row gives an SM fewer threads).
template <typename V>
struct FedaggRing {
    static constexpr int ROWS = sizeof(V) == 16 ? 32 : 64;
};

// Packed entry i, or 0 past n_live (never used: every use of an entry
// is guarded by the same bound).
__device__ __forceinline__ float ws_coef(const float* __restrict__ coef,
                                         int n_live, int i) {
    return i < n_live ? __ldg(coef + i) : 0.0f;
}
__device__ __forceinline__ int ws_row(const int* __restrict__ rows,
                                      int n_live, int i) {
    return i < n_live ? __ldg(rows + i) : 0;
}

// The stream: each block grid-strides over the columns, each thread owns
// one vector V of them, and for each column pass the thread folds the
// n_live packed rows in order through its ring of R row slots.  Slot s
// holds row j0 + s of the round from j0; folding it frees the slot for
// row j0 + s + R.  ci[q] (lane l) holds the coefficient of row
// j0 + 32q + l, ri[q] the index of row j0 + R + 32q + l; the next
// round's are loaded at the start of this one.  Every branch on a row
// count is uniform over the block, so the shuffles see every lane; a
// thread past p neither loads nor stores.
template <typename V, int MODE>
__global__ void __launch_bounds__(FEDAGG_THREADS)
fedagg_ws_kernel(const float* __restrict__ u, const float* __restrict__ g,
                 const float* __restrict__ ws, float* __restrict__ out,
                 int n, long long p) {
    constexpr int VEC = sizeof(V) / sizeof(float);
    constexpr int R = FedaggRing<V>::ROWS;
    constexpr int Q = R / 32;
    static_assert(R % 32 == 0, "the ring holds whole chunks of 32 rows");
    const float* coef = ws;
    const int* rows = reinterpret_cast<const int*>(ws + n);
    const int n_live = reinterpret_cast<const int*>(ws)[2LL * n];
    const float c0 = MODE == FEDAGG_FOLD ? ws[2LL * n + 1] : 0.0f;
    const int lane = threadIdx.x & 31;

    const long long step = (long long)gridDim.x * blockDim.x * VEC;
    for (long long base = (long long)blockIdx.x * blockDim.x * VEC;
         base < p; base += step) {
        const long long col = base + (long long)threadIdx.x * VEC;
        const bool mine = col < p;
        const float* uc = u + (mine ? col : 0);
        V acc = V();
        V x[R];
        float ci[Q];
        int ri[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {         // the first round's rows
            const int i = 32 * q + lane;
            const int r = ws_row(rows, n_live, i);
#pragma unroll
            for (int l = 0; l < 32; ++l) {
                const int row = __shfl_sync(0xffffffffu, r, l);
                if (mine && 32 * q + l < n_live)
                    x[32 * q + l] = ldg(reinterpret_cast<const V*>(
                        uc + (long long)row * p));
            }
            ci[q] = ws_coef(coef, n_live, i);
            ri[q] = ws_row(rows, n_live, R + i);
        }
        for (int j0 = 0; j0 < n_live; j0 += R) {
            float cn[Q];
            int rn[Q];
#pragma unroll
            for (int q = 0; q < Q; ++q) {     // the next round's entries
                const int i = j0 + R + 32 * q + lane;
                cn[q] = ws_coef(coef, n_live, i);
                rn[q] = ws_row(rows, n_live, R + i);
            }
#pragma unroll
            for (int s = 0; s < R; ++s) {
                const int q = s / 32, l = s % 32;
                const float e = __shfl_sync(0xffffffffu, ci[q], l);
                const int row = __shfl_sync(0xffffffffu, ri[q], l);
                if (j0 + s < n_live) fma_into(e, x[s], acc);
                if (mine && j0 + R + s < n_live)
                    x[s] = ldg(reinterpret_cast<const V*>(
                        uc + (long long)row * p));
            }
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                ci[q] = cn[q];
                ri[q] = rn[q];
            }
        }
        if (mine) {
            // c0 == 0: the global row is neither read nor multiplied
            if (MODE == FEDAGG_FOLD && c0 > 0.0f)
                acc = global_plus(c0, ldg(reinterpret_cast<const V*>(g + col)),
                                  acc);
            *reinterpret_cast<V*>(out + col) = acc;
        }
    }
}

// The stream's grid for p columns in vectors V: the narrowest blocks
// (whole warps, 32 to FEDAGG_THREADS threads) that cover the columns in
// one wave of k blocks an SM, k = 1, 2, ... while k of them fit an SM;
// else blocks of FEDAGG_THREADS, as many as are resident, striding.
template <typename V, int MODE>
static int ws_grid(long long p, unsigned* blocks, unsigned* threads) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const long long vectors = p / (long long)(sizeof(V) / sizeof(float));
    for (int k = 1;; ++k) {
        const long long per = (long long)sms * k;
        long long t = ((vectors + per - 1) / per + 31) / 32 * 32;
        t = t < 32 ? 32 : t > FEDAGG_THREADS ? FEDAGG_THREADS : t;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fedagg_ws_kernel<V, MODE>, (int)t, 0);
        if (err != cudaSuccess) return (int)err;
        const long long b = (vectors + t - 1) / t;
        const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
        if (b <= resident || t == 32 || per_sm < k) {
            *blocks = (unsigned)(b < resident ? b : resident);
            *threads = (unsigned)t;
            return 0;
        }
    }
}

template <typename V, int MODE>
static int launch_ws(const float* u, const float* g, const float* c,
                     const float* a, float* out, float* ws, int n,
                     long long p, cudaStream_t stream) {
    unsigned blocks = 0, threads = 0;
    const int err = ws_grid<V, MODE>(p, &blocks, &threads);
    if (err != 0) return err;
    fedagg_preamble_kernel<MODE><<<1, FEDAGG_PRE_THREADS, 0, stream>>>(
        c, a, n, ws);
    const cudaError_t pre = cudaGetLastError();
    if (pre != cudaSuccess) return (int)pre;
    fedagg_ws_kernel<V, MODE><<<blocks, threads, 0, stream>>>(
        u, g, ws, out, n, p);
    return (int)cudaGetLastError();
}

template <int MODE>
static int launch_ws_vec(const void* u, const void* g, const void* c,
                         const void* a, void* out, void* ws, int n,
                         long long p, int vec, void* stream) {
    if (n < 1 || n > FEDAGG_WS_MAX_ROWS || p < 1 || vec < 1 || p % vec != 0
            || ws == nullptr)
        return (int)cudaErrorInvalidValue;
    const float* uf = static_cast<const float*>(u);
    const float* gf = static_cast<const float*>(g);
    const float* cf = static_cast<const float*>(c);
    const float* af = static_cast<const float*>(a);
    float* of = static_cast<float*>(out);
    float* wf = static_cast<float*>(ws);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (vec) {
        case 4: return launch_ws<float4, MODE>(uf, gf, cf, af, of, wf, n, p, s);
        case 2: return launch_ws<float2, MODE>(uf, gf, cf, af, of, wf, n, p, s);
        case 1: return launch_ws<float, MODE>(uf, gf, cf, af, of, wf, n, p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// fedagg_f32's arguments and its result past FEDAGG_MAX_ROWS rows, with
// ws a device workspace of fedagg_ws_floats(n) floats that the two
// launches own until they have run.  Returns cudaGetLastError() after
// the launches; does not synchronise.
extern "C" int fedagg_f32_ws(const void* u, const void* w, const void* a,
                             void* out, void* ws, int n, long long p,
                             int vec, void* stream) {
    return launch_ws_vec<FEDAGG_AVG>(u, nullptr, w, a, out, ws, n, p, vec,
                                     stream);
}

// fedagg_fold_f32's, past FEDAGG_MAX_ROWS coefficients: k rows, ws of
// fedagg_ws_floats(k) floats.
extern "C" int fedagg_fold_f32_ws(const void* u, const void* g,
                                  const void* coef, void* out, void* ws,
                                  int k, long long p, int vec,
                                  void* stream) {
    return launch_ws_vec<FEDAGG_FOLD>(u, g, coef, nullptr, out, ws, k, p,
                                      vec, stream);
}

// fedagg_partial_f32's, past FEDAGG_MAX_ROWS rows: ws of
// fedagg_ws_floats(n) floats.
extern "C" int fedagg_partial_f32_ws(const void* u, const void* coef,
                                     void* out, void* ws, int n,
                                     long long p, int vec, void* stream) {
    return launch_ws_vec<FEDAGG_PARTIAL>(u, nullptr, coef, nullptr, out, ws,
                                         n, p, vec, stream);
}
