// Causal flash attention for Hopper (sm_90a): forward, dK/dV and dQ.
//
// Replaces the three Pallas TPU kernels of shockwave_tpu/ops/flash_attention.py:
//   flash_fwd  <- _fwd_kernel  (pallas_call in _flash_fwd_flat)
//   flash_dkv  <- _dkv_kernel  (first pallas_call in _flash_bwd_flat)
//   flash_dq   <- _dq_kernel   (second pallas_call in _flash_bwd_flat)
//
// Contract (the wrapper in ../flash_attention.py prepares it):
//   q      [B*H,   S, D]  input dtype, already multiplied by 1/sqrt(D) in f32
//                         and cast back, as the TPU wrapper does;
//   k, v   [B*Hkv, S, D]  query head h reads KV head h / group (GQA);
//   lse    [B*H, S] f32   (no 128-lane replication: that was TPU tiling);
//   delta  [B*H, S] f32   rowsum(dout * out), computed outside;
//   dk, dv [B*H, S, D]    per query head, group-summed by the wrapper.
// Causal, with an optional sliding window: row r attends cols (r-window, r].
// Dead score entries take the mask value -1e30, as on the TPU.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the training
// shape (B*H = 64, S = 2048, D = 128, bf16) the forward does 2 products of
// 2*S*S/2*D flops per head (~69 GFLOP), dkv 4 (~137 GFLOP), dq 3 (~103 GFLOP),
// against ~34 MB per q/k/v/o tensor: all three are bound by tensor-core
// operations, not bytes.
//
// Design. The TPU grid's sequential ("arbitrary") axis becomes a loop inside
// one CTA: forward and dq run one CTA per (q tile, b*h) and walk k tiles;
// dkv runs one CTA per (k tile, b*h) and walks q tiles. Nothing carries
// between CTAs. Causal and window skipping are loop bounds; only tiles
// straddling the diagonal or the window edge pay for the per-element mask
// (the TPU's _causal_block_split). Tiles are 64 rows; each of the four warps
// owns a 16-row strip.
//
// bfloat16, the training dtype, takes the tensor cores: mma.sync m16n8k16
// (bf16 in, f32 accumulate) with operands fed by ldmatrix from padded shared
// tiles, and every accumulator (scores, the running output, dq, dk, dv) in
// registers. A score strip leaves its products as accumulator fragments
// whose layout is the A-operand layout of the next product, so p and ds go
// from registers straight into P.V, dS.K, P^T.dO and dS^T.Q without a trip
// through shared memory. The next k (or q) tile streams in with cp.async
// while the current one is multiplied. That is the simple way onto the
// tensor cores; wgmma, TMA and warp specialisation, which the card's full
// rate needs, are not used here. float32 inputs (tests, reference runs)
// take a SIMT path with the same tiling and the products staged in shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;   // rows of a q tile and of a k tile
constexpr int WARPS = 4;   // warp w owns rows [16w, 16w + 16) of a tile
constexpr int THREADS = WARPS * 32;
constexpr float MASK_VALUE = -1e30f;

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Flat KV row of flat query row b ([B*H] batch-major, head-minor), as _kv_row.
__device__ __forceinline__ int kv_row(int b, int num_q_heads, int group) {
  return (b / num_q_heads) * (num_q_heads / group) + (b % num_q_heads) / group;
}

__device__ __forceinline__ bool dead(int row, int col, int window) {
  return col > row || (window > 0 && col < row - (window - 1));
}

// A tile is fully live when no entry is masked: below the diagonal and,
// with a window, entirely inside it.
__device__ __forceinline__ bool tile_full(int first_row, int first_col, int window) {
  const int last_row = first_row + TILE - 1, last_col = first_col + TILE - 1;
  return last_col <= first_row && (window <= 0 || first_col >= last_row - (window - 1));
}

// First k tile a q tile sees, and last q tile that sees a k tile.
__device__ __forceinline__ int first_k_tile(int first_row, int window) {
  return window > 0 ? max(0, first_row - (window - 1)) / TILE : 0;
}
__device__ __forceinline__ int last_q_tile(int first_col, int window, int num_tiles) {
  return window > 0 ? min(num_tiles - 1, (first_col + TILE - 1 + window - 1) / TILE)
                    : num_tiles - 1;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, register accumulators
// ---------------------------------------------------------------------------

// Shared tiles are [TILE, D] with rows padded by 8 elements (16 bytes): the
// eight 16-byte rows an ldmatrix phase reads then fall on distinct banks.
template <int D> struct Bf16Tile {
  static constexpr int LD = D + 8;
  static constexpr size_t bytes = sizeof(bf16) * TILE * LD;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying a [TILE, D] tile (global row stride D) into shared memory.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src) {
  constexpr int PER_ROW = D / 8;  // 16-byte chunks
  for (int idx = threadIdx.x; idx < TILE * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * 8;
    cp_async16(dst + r * Bf16Tile<D>::LD + c, src + static_cast<size_t>(r) * D + c);
  }
}

// Start copying TILE floats of each of two per-row stats.
__device__ __forceinline__ void load_rows_async(float* dst_a, const float* src_a, float* dst_b,
                                                const float* src_b) {
  const int i = threadIdx.x;  // 16 chunks of 4 floats each
  if (i < TILE / 4) cp_async16(dst_a + 4 * i, src_a + 4 * i);
  else if (i < TILE / 2) cp_async16(dst_b + 4 * (i - TILE / 4), src_b + 4 * (i - TILE / 4));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] * b[16x8]; bf16 operands, f32 accumulators. In a
// warp, lane = 4g + t holds c rows g and g + 8, columns 2t and 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even, as torch's .to()) in one
// register, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of the 16x16 block at `p` of a row-major shared tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p, int ld) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, p + (lane & 15) * ld + (lane >> 4) * 8);
}

// B fragments of two n8 tiles, b = X^T with X stored [n][k] at `p`:
// (b[0], b[1]) for columns n..n+7, (b[2], b[3]) for n+8..n+15.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* p, int ld) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, p + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8);
}

// The same for b = Y with Y stored [k][n] at `p` (transposed on load).
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* p, int ld) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, p + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + (lane >> 4) * 8);
}

// acc[16, N] += A[16, K] . X[N, K]^T: A the warp's strip of a shared tile,
// X a whole shared tile. Scores s = q.k^T and dp = g.v^T (and transposed).
template <int N, int K>
__device__ __forceinline__ void strip_abt(float (&acc)[N / 8][4], const bf16* A, const bf16* X,
                                          int ld) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    load_a(a, A + k0, ld);
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t b[4];
      load_b_nk(b, X + n0 * ld + k0, ld);
      mma_bf16(acc[n0 / 8], a, b[0], b[1]);
      mma_bf16(acc[n0 / 8 + 1], a, b[2], b[3]);
    }
  }
}

// acc[16, N] += P[16, TILE] . Y[TILE, N]: P a strip of accumulator
// fragments (rounded to bf16 here, as the TPU kernels cast p and ds to the
// input dtype), Y a whole shared tile. o += p.v, dq += ds.k, dv += p^T.g,
// dk += ds^T.q.
template <int N>
__device__ __forceinline__ void strip_pv(float (&acc)[N / 8][4], const float (&p)[TILE / 8][4],
                                         const bf16* Y, int ld) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t b[4];
      load_b_kn(b, Y + kk * 16 * ld + n0, ld);
      mma_bf16(acc[n0 / 8], a, b[0], b[1]);
      mma_bf16(acc[n0 / 8 + 1], a, b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// Mask a strip whose fragment rows are (row_of(0), row_of(8)) and whose
// columns start at first_col. transposed: the strip's rows are keys and its
// columns queries (dkv's s^T).
__device__ __forceinline__ void mask_strip(float (&s)[TILE / 8][4], int row0, int first_col,
                                           bool transposed, int window) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + (e >> 1) * 8, c = first_col + 8 * j + 2 * t + (e & 1);
      if (transposed ? dead(c, r, window) : dead(r, c, window)) s[j][e] = MASK_VALUE;
    }
  }
}

// Store a [16, D] f32 strip (rows r and r + 8 of `dst`, row stride D) as bf16.
template <int D>
__device__ __forceinline__ void store_strip(bf16* dst, const float (&acc)[D / 8][4], float s0,
                                            float s1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(dst + g * D + 8 * n + 2 * t) =
        pack_bf16(acc[n][0] * s0, acc[n][1] * s0);
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * D + 8 * n + 2 * t) =
        pack_bf16(acc[n][2] * s1, acc[n][3] * s1);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D> struct Bf16Smem {
  static constexpr size_t fwd = 5 * Bf16Tile<D>::bytes;   // q, 2 x (k, v)
  static constexpr size_t dq = 6 * Bf16Tile<D>::bytes;    // q, g, 2 x (k, v)
  static constexpr size_t dkv = 6 * Bf16Tile<D>::bytes + 4 * TILE * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
               int S, int H, int group, int window) {
  constexpr int LD = Bf16Tile<D>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + TILE * LD;      // two buffers
  bf16* sV = sK + 2 * TILE * LD;  // two buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest k walks first
  const int bh = blockIdx.y;
  const int first_row = qt * TILE;
  const size_t kv_off = static_cast<size_t>(kv_row(bh, H, group)) * S * D;
  const int kt_lo = first_k_tile(first_row, window);

  load_tile_async<D>(sQ, q + (static_cast<size_t>(bh) * S + first_row) * D);
  load_tile_async<D>(sK, k + kv_off + static_cast<size_t>(kt_lo) * TILE * D);
  load_tile_async<D>(sV, v + kv_off + static_cast<size_t>(kt_lo) * TILE * D);
  cp_async_commit();

  uint32_t qf[D / 16][4];  // the warp's q strip, kept in registers
  float o[D / 8][4];
  zero(o);
  // Running max and sum of this lane's two rows (strip rows g and g + 8).
  float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.f, l1 = 0.f;
  const int row0 = first_row + 16 * warp + (lane >> 2);

  for (int kt = kt_lo; kt <= qt; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt < qt) {  // stream the next tile into the other buffer
      const size_t next = kv_off + static_cast<size_t>(kt + 1) * TILE * D;
      load_tile_async<D>(sK + (buf ^ 1) * TILE * LD, k + next);
      load_tile_async<D>(sV + (buf ^ 1) * TILE * LD, v + next);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just requested
    __syncthreads();
    if (kt == kt_lo) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], sQ + 16 * warp * LD + 16 * kk, LD);
    }
    const bf16* cK = sK + buf * TILE * LD;
    const bf16* cV = sV + buf * TILE * LD;

    float s[TILE / 8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n0 = 0; n0 < TILE; n0 += 16) {
        uint32_t b[4];
        load_b_nk(b, cK + n0 * LD + 16 * kk, LD);
        mma_bf16(s[n0 / 8], qf[kk], b[0], b[1]);
        mma_bf16(s[n0 / 8 + 1], qf[kk], b[2], b[3]);
      }
    }
    if (!tile_full(first_row, kt * TILE, window)) mask_strip(s, row0, kt * TILE, false, window);

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      s[j][0] = expf(s[j][0] - mx0);
      s[j][1] = expf(s[j][1] - mx0);
      s[j][2] = expf(s[j][2] - mx1);
      s[j][3] = expf(s[j][3] - mx1);
      r0 += s[j][0] + s[j][1];
      r1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + quad_sum(r0);
    l1 = l1 * c1 + quad_sum(r1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }
    strip_pv<D>(o, s, cV, LD);  // p in bf16 for P.V, as the TPU kernel does
    __syncthreads();  // this buffer is refilled two iterations on
  }

  store_strip<D>(out + (static_cast<size_t>(bh) * S + first_row + 16 * warp) * D, o,
                 1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f));
  if ((lane & 3) == 0) {
    lse[static_cast<size_t>(bh) * S + row0] = m0 + logf(l0 + 1e-30f);
    lse[static_cast<size_t>(bh) * S + row0 + 8] = m1 + logf(l1 + 1e-30f);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int S, int H, int group, int window, float scale) {
  constexpr int LD = Bf16Tile<D>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + TILE * LD;
  bf16* sK = sG + TILE * LD;      // two buffers
  bf16* sV = sK + 2 * TILE * LD;  // two buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest k walks first
  const int bh = blockIdx.y;
  const int first_row = qt * TILE;
  const size_t q_off = (static_cast<size_t>(bh) * S + first_row) * D;
  const size_t kv_off = static_cast<size_t>(kv_row(bh, H, group)) * S * D;
  const int kt_lo = first_k_tile(first_row, window);

  load_tile_async<D>(sQ, q + q_off);
  load_tile_async<D>(sG, g + q_off);
  load_tile_async<D>(sK, k + kv_off + static_cast<size_t>(kt_lo) * TILE * D);
  load_tile_async<D>(sV, v + kv_off + static_cast<size_t>(kt_lo) * TILE * D);
  cp_async_commit();

  const int row0 = first_row + 16 * warp + (lane >> 2);
  const float lse0 = lse[static_cast<size_t>(bh) * S + row0];
  const float lse1 = lse[static_cast<size_t>(bh) * S + row0 + 8];
  const float delta0 = delta[static_cast<size_t>(bh) * S + row0];
  const float delta1 = delta[static_cast<size_t>(bh) * S + row0 + 8];
  float acc[D / 8][4];
  zero(acc);

  for (int kt = kt_lo; kt <= qt; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt < qt) {
      const size_t next = kv_off + static_cast<size_t>(kt + 1) * TILE * D;
      load_tile_async<D>(sK + (buf ^ 1) * TILE * LD, k + next);
      load_tile_async<D>(sV + (buf ^ 1) * TILE * LD, v + next);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cK = sK + buf * TILE * LD;
    const bf16* cV = sV + buf * TILE * LD;

    float s[TILE / 8][4], dp[TILE / 8][4];
    zero(s);
    zero(dp);
    strip_abt<TILE, D>(s, sQ + 16 * warp * LD, cK, LD);
    strip_abt<TILE, D>(dp, sG + 16 * warp * LD, cV, LD);
    if (!tile_full(first_row, kt * TILE, window)) mask_strip(s, row0, kt * TILE, false, window);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {  // s becomes ds = p * (dp - delta)
      s[j][0] = expf(s[j][0] - lse0) * (dp[j][0] - delta0);
      s[j][1] = expf(s[j][1] - lse0) * (dp[j][1] - delta0);
      s[j][2] = expf(s[j][2] - lse1) * (dp[j][2] - delta1);
      s[j][3] = expf(s[j][3] - lse1) * (dp[j][3] - delta1);
    }
    strip_pv<D>(acc, s, cK, LD);  // dq += ds.k
    __syncthreads();
  }
  // ds.k used the unscaled ds; 1/sqrt(D) lands once here, as on the TPU.
  store_strip<D>(dq + q_off + static_cast<size_t>(16 * warp) * D, acc, scale, scale);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int group,
               int window) {
  constexpr int LD = Bf16Tile<D>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE * LD;
  bf16* sQ = sV + TILE * LD;      // two buffers
  bf16* sG = sQ + 2 * TILE * LD;  // two buffers
  float* sL = reinterpret_cast<float*>(sG + 2 * TILE * LD);  // two buffers
  float* sDelta = sL + 2 * TILE;                             // two buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kt = blockIdx.x;  // k tile 0 walks the most q tiles: first
  const int bh = blockIdx.y;
  const int first_col = kt * TILE;
  const int qt_hi = last_q_tile(first_col, window, S / TILE);
  const size_t kv_off = (static_cast<size_t>(kv_row(bh, H, group)) * S + first_col) * D;
  const size_t row_base = static_cast<size_t>(bh) * S;

  load_tile_async<D>(sK, k + kv_off);
  load_tile_async<D>(sV, v + kv_off);
  load_tile_async<D>(sQ, q + (row_base + first_col) * D);
  load_tile_async<D>(sG, g + (row_base + first_col) * D);
  load_rows_async(sL, lse + row_base + first_col, sDelta, delta + row_base + first_col);
  cp_async_commit();

  // This lane's strip rows are keys key0 and key0 + 8; its columns queries.
  const int key0 = first_col + 16 * warp + (lane >> 2);
  const int t = lane & 3;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int qt = kt; qt <= qt_hi; ++qt) {
    const int buf = (qt - kt) & 1;
    if (qt < qt_hi) {
      const size_t next = row_base + static_cast<size_t>(qt + 1) * TILE;
      load_tile_async<D>(sQ + (buf ^ 1) * TILE * LD, q + next * D);
      load_tile_async<D>(sG + (buf ^ 1) * TILE * LD, g + next * D);
      load_rows_async(sL + (buf ^ 1) * TILE, lse + next, sDelta + (buf ^ 1) * TILE, delta + next);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cQ = sQ + buf * TILE * LD;
    const bf16* cG = sG + buf * TILE * LD;
    const float* cL = sL + buf * TILE;
    const float* cDelta = sDelta + buf * TILE;
    const int first_row = qt * TILE;

    // Transposed strips: p^T = exp(k.q^T - lse), dp^T = v.g^T.
    float pt[TILE / 8][4], dst[TILE / 8][4];
    zero(pt);
    zero(dst);
    strip_abt<TILE, D>(pt, sK + 16 * warp * LD, cQ, LD);
    strip_abt<TILE, D>(dst, sV + 16 * warp * LD, cG, LD);
    if (!tile_full(first_row, first_col, window)) mask_strip(pt, key0, first_row, true, window);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(cL + 8 * j + 2 * t);
      const float2 d = *reinterpret_cast<const float2*>(cDelta + 8 * j + 2 * t);
      pt[j][0] = expf(pt[j][0] - l.x);
      pt[j][1] = expf(pt[j][1] - l.y);
      pt[j][2] = expf(pt[j][2] - l.x);
      pt[j][3] = expf(pt[j][3] - l.y);
      dst[j][0] = pt[j][0] * (dst[j][0] - d.x);  // ds^T = p^T * (dp^T - delta)
      dst[j][1] = pt[j][1] * (dst[j][1] - d.y);
      dst[j][2] = pt[j][2] * (dst[j][2] - d.x);
      dst[j][3] = pt[j][3] * (dst[j][3] - d.y);
    }
    strip_pv<D>(dv_acc, pt, cG, LD);   // dv += p^T.g
    strip_pv<D>(dk_acc, dst, cQ, LD);  // dk += ds^T.q (q carries the scale)
    __syncthreads();
  }
  const size_t d_off = (row_base + first_col + 16 * warp) * D;
  store_strip<D>(dk + d_off, dk_acc, 1.f, 1.f);
  store_strip<D>(dv + d_off, dv_acc, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// float32: SIMT FMAs, products staged in shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy a [TILE, D] row-major tile from global memory (row stride D) into
// shared memory (row stride D), 16 bytes a thread.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src) {
  constexpr int PER_ROW = D / 4;
  for (int idx = threadIdx.x; idx < TILE * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * 4;
    *reinterpret_cast<float4*>(dst + r * D + c) =
        *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * D + c);
  }
}

template <int N>
__device__ __forceinline__ void zero_rows(float* dst) {
  for (int idx = threadIdx.x; idx < TILE * N; idx += THREADS) dst[idx] = 0.f;
}

// One warp: C[16, N] = (acc ? C : 0) + A[16, K] * B[K, N].
// TA: A is stored transposed (element (i, k) at A[k * lda + i]).
// TB: B is stored transposed (element (k, j) at B[j * ldb + k]).
template <bool TA, bool TB, int N, int K>
__device__ __forceinline__ void warp_gemm(const float* A, int lda, const float* B, int ldb,
                                          float* C, int ldc, bool acc) {
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < 16 * N; idx += 32) {
    const int i = idx / N, j = idx % N;
    float s = acc ? C[i * ldc + j] : 0.f;
#pragma unroll 8
    for (int kk = 0; kk < K; ++kk) {
      const float a = TA ? A[kk * lda + i] : A[i * lda + kk];
      const float b = TB ? B[j * ldb + kk] : B[kk * ldb + j];
      s = fmaf(a, b, s);
    }
    C[i * ldc + j] = s;
  }
  __syncwarp();
}

// Shared-memory layout of each f32 kernel, shared by the kernel and its launch.
template <int D>
struct F32Smem {
  static constexpr size_t kOperand = align128(sizeof(float) * TILE * D);
  static constexpr size_t kScore = align128(sizeof(float) * TILE * TILE);
  static constexpr size_t kRow = align128(sizeof(float) * TILE);
  static constexpr size_t fwd = 4 * kOperand + kScore;  // q, k, v, o; s
  static constexpr size_t dkv = 6 * kOperand + 2 * kScore + 2 * kRow;
  static constexpr size_t dq = 5 * kOperand + 2 * kScore + 2 * kRow;
};

// Recompute one 16-row strip of p = exp(s - lse) and ds = p * (dp - delta)
// for the tile at (first_row, first_col), in place of s and dp.
__device__ __forceinline__ void probs_and_dscores(float* S_w, float* dP_w, const float* lse_w,
                                                  const float* delta_w, int row0, int first_col,
                                                  bool full, int window) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int row = row0 + i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      float s = S_w[i * TILE + c];
      if (!full && dead(row, first_col + c, window)) s = MASK_VALUE;
      const float pr = expf(s - lse_w[i]);  // dead entries -> 0
      S_w[i * TILE + c] = pr;
      dP_w[i * TILE + c] = pr * (dP_w[i * TILE + c] - delta_w[i]);
    }
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
              int S, int H, int group, int window) {
  using L = F32Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  float* sQ = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sK = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sV = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sO = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sS = reinterpret_cast<float*>(p);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest k walks first
  const int bh = blockIdx.y;
  const int first_row = qt * TILE;
  const float* kbase = k + static_cast<size_t>(kv_row(bh, H, group)) * S * D;
  const float* vbase = v + static_cast<size_t>(kv_row(bh, H, group)) * S * D;

  load_tile<D>(sQ, q + (static_cast<size_t>(bh) * S + first_row) * D);
  zero_rows<D>(sO);

  float m_row[16], l_row[16];  // every lane holds its warp's 16 rows
#pragma unroll
  for (int i = 0; i < 16; ++i) { m_row[i] = MASK_VALUE; l_row[i] = 0.f; }

  float* S_w = sS + 16 * warp * TILE;
  float* O_w = sO + 16 * warp * D;
  for (int kt = first_k_tile(first_row, window); kt <= qt; ++kt) {
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile<D>(sK, kbase + static_cast<size_t>(kt) * TILE * D);
    load_tile<D>(sV, vbase + static_cast<size_t>(kt) * TILE * D);
    __syncthreads();
    const int first_col = kt * TILE;
    const bool full = tile_full(first_row, first_col, window);

    warp_gemm<false, true, TILE, D>(sQ + 16 * warp * D, D, sK, D, S_w, TILE, false);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = first_row + 16 * warp + i;
      float s0 = S_w[i * TILE + lane], s1 = S_w[i * TILE + lane + 32];
      if (!full) {
        if (dead(row, first_col + lane, window)) s0 = MASK_VALUE;
        if (dead(row, first_col + lane + 32, window)) s1 = MASK_VALUE;
      }
      const float m_new = fmaxf(m_row[i], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float corr = expf(m_row[i] - m_new);
      l_row[i] = l_row[i] * corr + warp_sum(p0 + p1);
      m_row[i] = m_new;
      S_w[i * TILE + lane] = p0;
      S_w[i * TILE + lane + 32] = p1;
      for (int c = lane; c < D; c += 32) O_w[i * D + c] *= corr;
    }
    __syncwarp();
    warp_gemm<false, false, D, TILE>(S_w, TILE, sV, D, O_w, D, true);
  }

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = first_row + 16 * warp + i;
    const float inv = 1.f / fmaxf(l_row[i], 1e-30f);
    float* orow = out + (static_cast<size_t>(bh) * S + row) * D;
    for (int c = lane; c < D; c += 32) orow[c] = O_w[i * D + c] * inv;
    if (lane == 0) lse[static_cast<size_t>(bh) * S + row] = m_row[i] + logf(l_row[i] + 1e-30f);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int S, int H, int group,
              int window) {
  using L = F32Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  float* sK = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sV = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sQ = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sG = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sdK = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sdV = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sS = reinterpret_cast<float*>(p); p += L::kScore;
  float* sdP = reinterpret_cast<float*>(p); p += L::kScore;
  float* sL = reinterpret_cast<float*>(p); p += L::kRow;
  float* sDelta = reinterpret_cast<float*>(p);

  const int warp = threadIdx.x >> 5;
  const int kt = blockIdx.x;  // k tile 0 walks the most q tiles: first
  const int bh = blockIdx.y;
  const int first_col = kt * TILE;
  const size_t kv_off = (static_cast<size_t>(kv_row(bh, H, group)) * S + first_col) * D;
  load_tile<D>(sK, k + kv_off);
  load_tile<D>(sV, v + kv_off);
  zero_rows<D>(sdK);
  zero_rows<D>(sdV);

  const int qt_hi = last_q_tile(first_col, window, S / TILE);
  for (int qt = kt; qt <= qt_hi; ++qt) {
    const int first_row = qt * TILE;
    const size_t q_off = (static_cast<size_t>(bh) * S + first_row) * D;
    __syncthreads();  // the previous q tile is no longer read
    load_tile<D>(sQ, q + q_off);
    load_tile<D>(sG, g + q_off);
    for (int r = threadIdx.x; r < TILE; r += THREADS) {
      sL[r] = lse[static_cast<size_t>(bh) * S + first_row + r];
      sDelta[r] = delta[static_cast<size_t>(bh) * S + first_row + r];
    }
    __syncthreads();
    const bool full = tile_full(first_row, first_col, window);

    // Strips over q rows: s = q.k^T, dp = g.v^T, then p and ds.
    const int r0 = 16 * warp;
    warp_gemm<false, true, TILE, D>(sQ + r0 * D, D, sK, D, sS + r0 * TILE, TILE, false);
    warp_gemm<false, true, TILE, D>(sG + r0 * D, D, sV, D, sdP + r0 * TILE, TILE, false);
    probs_and_dscores(sS + r0 * TILE, sdP + r0 * TILE, sL + r0, sDelta + r0, first_row + r0,
                      first_col, full, window);
    __syncthreads();  // dv and dk contract over all 64 q rows

    // Strips over k rows: dv += p^T.g, dk += ds^T.q (q carries the scale).
    warp_gemm<true, false, D, TILE>(sS + r0, TILE, sG, D, sdV + r0 * D, D, true);
    warp_gemm<true, false, D, TILE>(sdP + r0, TILE, sQ, D, sdK + r0 * D, D, true);
  }
  __syncthreads();
  const size_t d_off = (static_cast<size_t>(bh) * S + first_col) * D;
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    dk[d_off + idx] = sdK[idx];
    dv[d_off + idx] = sdV[idx];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int S, int H, int group, int window, float scale) {
  using L = F32Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  float* sQ = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sG = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sK = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sV = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sdQ = reinterpret_cast<float*>(p); p += L::kOperand;
  float* sS = reinterpret_cast<float*>(p); p += L::kScore;
  float* sdP = reinterpret_cast<float*>(p); p += L::kScore;
  float* sL = reinterpret_cast<float*>(p); p += L::kRow;
  float* sDelta = reinterpret_cast<float*>(p);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest k walks first
  const int bh = blockIdx.y;
  const int first_row = qt * TILE;
  const size_t q_off = (static_cast<size_t>(bh) * S + first_row) * D;
  const float* kbase = k + static_cast<size_t>(kv_row(bh, H, group)) * S * D;
  const float* vbase = v + static_cast<size_t>(kv_row(bh, H, group)) * S * D;
  load_tile<D>(sQ, q + q_off);
  load_tile<D>(sG, g + q_off);
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    sL[r] = lse[static_cast<size_t>(bh) * S + first_row + r];
    sDelta[r] = delta[static_cast<size_t>(bh) * S + first_row + r];
  }
  zero_rows<D>(sdQ);

  const int r0 = 16 * warp;
  for (int kt = first_k_tile(first_row, window); kt <= qt; ++kt) {
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile<D>(sK, kbase + static_cast<size_t>(kt) * TILE * D);
    load_tile<D>(sV, vbase + static_cast<size_t>(kt) * TILE * D);
    __syncthreads();
    const int first_col = kt * TILE;
    const bool full = tile_full(first_row, first_col, window);
    warp_gemm<false, true, TILE, D>(sQ + r0 * D, D, sK, D, sS + r0 * TILE, TILE, false);
    warp_gemm<false, true, TILE, D>(sG + r0 * D, D, sV, D, sdP + r0 * TILE, TILE, false);
    probs_and_dscores(sS + r0 * TILE, sdP + r0 * TILE, sL + r0, sDelta + r0, first_row + r0,
                      first_col, full, window);
    warp_gemm<false, false, D, TILE>(sdP + r0 * TILE, TILE, sK, D, sdQ + r0 * D, D, true);
  }
  // ds.k used the unscaled ds; 1/sqrt(D) lands once here, as on the TPU.
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    float* row = dq + q_off + static_cast<size_t>(r0 + i) * D;
    for (int c = lane; c < D; c += 32) row[c] = sdQ[(r0 + i) * D + c] * scale;
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch_prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

#define LAUNCH(kernel, smem, grid, stream, ...)                        \
  do {                                                                 \
    cudaError_t err_ = launch_prepare(kernel, smem);                   \
    if (err_ != cudaSuccess) return err_;                              \
    kernel<<<grid, THREADS, smem, stream>>>(__VA_ARGS__);              \
    return cudaGetLastError();                                         \
  } while (0)

template <int D>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v, void* out, void* lse,
                dim3 grid, int S, int H, int group, int window, cudaStream_t stream) {
  if (dtype == 1) {
    LAUNCH(flash_fwd_bf16<D>, Bf16Smem<D>::fwd, grid, stream, static_cast<const bf16*>(q),
           static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(out),
           static_cast<float*>(lse), S, H, group, window);
  }
  LAUNCH(flash_fwd_f32<D>, F32Smem<D>::fwd, grid, stream, static_cast<const float*>(q),
         static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(out),
         static_cast<float*>(lse), S, H, group, window);
}

template <int D>
cudaError_t dkv(int dtype, const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, void* dk, void* dv, dim3 grid, int S, int H,
                int group, int window, cudaStream_t stream) {
  if (dtype == 1) {
    LAUNCH(flash_dkv_bf16<D>, Bf16Smem<D>::dkv, grid, stream, static_cast<const bf16*>(q),
           static_cast<const bf16*>(k), static_cast<const bf16*>(v),
           static_cast<const bf16*>(g), static_cast<const float*>(lse),
           static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S,
           H, group, window);
  }
  LAUNCH(flash_dkv_f32<D>, F32Smem<D>::dkv, grid, stream, static_cast<const float*>(q),
         static_cast<const float*>(k), static_cast<const float*>(v),
         static_cast<const float*>(g), static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), S, H,
         group, window);
}

template <int D>
cudaError_t dq(int dtype, const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, void* dq_out, dim3 grid, int S, int H,
               int group, int window, float scale, cudaStream_t stream) {
  if (dtype == 1) {
    LAUNCH(flash_dq_bf16<D>, Bf16Smem<D>::dq, grid, stream, static_cast<const bf16*>(q),
           static_cast<const bf16*>(k), static_cast<const bf16*>(v),
           static_cast<const bf16*>(g), static_cast<const float*>(lse),
           static_cast<const float*>(delta), static_cast<bf16*>(dq_out), S, H, group, window,
           scale);
  }
  LAUNCH(flash_dq_f32<D>, F32Smem<D>::dq, grid, stream, static_cast<const float*>(q),
         static_cast<const float*>(k), static_cast<const float*>(v),
         static_cast<const float*>(g), static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<float*>(dq_out), S, H, group, window,
         scale);
}

// Head dims 16, 32, 64, 128; dtype code 0 = float32, 1 = bfloat16.
#define DISPATCH(head_dim, CALL)                      \
  do {                                                \
    switch (head_dim) {                               \
      case 16: { constexpr int D = 16; return CALL; } \
      case 32: { constexpr int D = 32; return CALL; } \
      case 64: { constexpr int D = 64; return CALL; } \
      case 128: { constexpr int D = 128; return CALL; } \
    }                                                 \
    return cudaErrorInvalidValue;                     \
  } while (0)

bool bad_args(int dtype, int bh, int S) {
  return (dtype != 0 && dtype != 1) || bh < 1 || bh > 65535 || S < TILE || S % TILE != 0;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the launch's
// cudaGetLastError() (0 on success); the kernels run asynchronously on
// `stream` and allocate nothing. Tensors are contiguous and 16-byte aligned.
extern "C" int flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                         void* out, void* lse, int bh, int seq, int num_q_heads, int group,
                         int window, void* stream) {
  if (bad_args(dtype, bh, seq)) return cudaErrorInvalidValue;
  const dim3 grid(seq / TILE, bh);
  auto s = static_cast<cudaStream_t>(stream);
  DISPATCH(head_dim, (fwd<D>(dtype, q, k, v, out, lse, grid, seq, num_q_heads, group, window, s)));
}

extern "C" int flash_dkv(int dtype, int head_dim, const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta, void* dk, void* dv,
                         int bh, int seq, int num_q_heads, int group, int window, void* stream) {
  if (bad_args(dtype, bh, seq)) return cudaErrorInvalidValue;
  const dim3 grid(seq / TILE, bh);
  auto s = static_cast<cudaStream_t>(stream);
  DISPATCH(head_dim, (dkv<D>(dtype, q, k, v, g, lse, delta, dk, dv, grid, seq, num_q_heads, group,
                             window, s)));
}

extern "C" int flash_dq(int dtype, int head_dim, const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta, void* dq_out, int bh,
                        int seq, int num_q_heads, int group, int window, float scale,
                        void* stream) {
  if (bad_args(dtype, bh, seq)) return cudaErrorInvalidValue;
  const dim3 grid(seq / TILE, bh);
  auto s = static_cast<cudaStream_t>(stream);
  DISPATCH(head_dim, (dq<D>(dtype, q, k, v, g, lse, delta, dq_out, grid, seq, num_q_heads, group,
                            window, scale, s)));
}
