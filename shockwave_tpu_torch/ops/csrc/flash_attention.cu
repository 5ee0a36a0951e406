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
// Common design. The TPU grid's sequential ("arbitrary") axis becomes a loop
// inside one CTA: forward and dq run one CTA per (q tile, b*h) and walk k
// tiles; dkv runs one CTA per (k tile, b*h) and walks q tiles. Nothing
// carries between CTAs. Causal and window skipping are loop bounds; only
// tiles straddling the diagonal or the window edge pay for the per-element
// mask (the TPU's _causal_block_split). The walks that take longest are
// issued first.
//
// bfloat16 forward, dK/dV and dQ (the training path): wgmma, TMA and warp
// specialisation. A CTA is three warpgroups. The first is the producer: it
// gives its registers up (setmaxnreg) and one of its threads keeps a ring
// of two stages of tiles in flight with TMA (cp.async.bulk.tensor), each
// stage signalled by an mbarrier that counts the bytes in, and freed by an
// mbarrier that the consumers' eight warps arrive on. The other two are
// consumers with 240 registers a thread, each owning 64 rows of every
// product, so a CTA holds 128 rows and re-reads the other operand half as
// often as 64-row tiles would.
//   - Forward: 128 q rows a CTA, 128-wide k tiles. S = Q.K^T is a wgmma with
//     both operands in shared memory; p = exp(s - running max) is rounded to
//     bf16 in registers (the rounding the TPU kernel applies, at the running
//     max of each 128-wide tile), and O += P.V is a wgmma with A = p from
//     registers (the f32 accumulator layout packs straight into the
//     A-fragment layout) and B = V, which is MN-major (transpose bit set).
//   - dK/dV: 128 keys a CTA, 64-row q tiles brought in with their lse and
//     delta rows (a 1-D bulk copy). Per q tile, transposed so that the
//     consumers own key rows: S^T = K.Q^T and dP^T = V.g^T from shared
//     memory, P^T = exp(S^T - lse), dS^T = P^T * (dP^T - delta), then
//     dV += P^T.g and dK += dS^T.Q with A in registers and the same q and g
//     tiles read MN-major. dk and dv stay in registers for the whole walk.
//   - dQ (replaces _dq_kernel): 128 q rows a CTA with their g rows, both
//     loaded once, and 128-wide k tiles with their v tiles in the ring. Per
//     k tile: S = Q.K^T and dP = g.V^T from shared memory, issued together;
//     P = exp(S - lse), dS = P * (dP - delta) in registers, rounded to bf16
//     as the A operand of dQ += dS.K, which reads the same K tile again
//     MN-major (two descriptors on one swizzled tile). dq stays in
//     registers for the whole walk and 1/sqrt(D) lands once, at the store.
//     Bound at the training shape: 3 products, ~103 GFLOP, 0.104 ms of
//     tensor-core time; its bytes take ~0.05 ms.
//     S, dP and the exp alone run at ~90% of the tensor rate; dS.K, a
//     third of the products, takes the rest of the time, whether A comes
//     from registers or from shared memory, and whether its stage is freed
//     early or a third stage is added: the chain S, dP -> exp -> dS.K in
//     each warpgroup is what the card waits on. The two warpgroups take
//     turns at issuing S and dP (two named barriers), so that they fall
//     out of step: 5% faster. 128-wide k tiles measured 8% faster than
//     64-wide ones (half the waits per key).
// What bounds the forward and dK/dV here is not the tensor cores or the
// bytes (a forward with P.V removed, or with the V loads removed too, took
// as long) but the f32 work between the products and the fixed cost of
// each CTA. So exp is ex2.approx of x * log2 e (three instructions where
// expf takes eight), and the outputs leave through swizzled shared memory
// and TMA stores that drain while the next CTA starts. Overlapping the
// softmax with P.V inside a warpgroup, a ping-pong order between the two
// warpgroups, a third stage, skipping the output rescale when no max
// moved, and skipping dK/dV steps whose keys are all dead measured no
// faster there and are not used.
// Tiles are loaded swizzled (128-byte rows, two 64-column halves at D = 128;
// 32/64-byte rows at D = 16/32), the layouts wgmma's descriptors read.
// Tensor maps are encoded on the host for each launch, through the runtime's
// driver entry point, so the library links no libcuda.
//
// float32 inputs (tests, reference runs) take a SIMT path with 64-row tiles
// and the products staged in shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;   // rows of a q tile and of a k tile (f32 kernels)
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

// A [rows, cols] tile of scores is fully live when no entry is masked: below
// the diagonal and, with a window, entirely inside it.
__device__ __forceinline__ bool tile_full(int first_row, int rows, int first_col, int cols,
                                          int window) {
  const int last_row = first_row + rows - 1, last_col = first_col + cols - 1;
  return last_col <= first_row && (window <= 0 || first_col >= last_row - (window - 1));
}

// First BLOCK-wide k tile that rows from first_row on can see, and the last
// BLOCK-row q tile that sees a key at or before last_col.
template <int BLOCK>
__device__ __forceinline__ int first_k_tile(int first_row, int window) {
  return window > 0 ? max(0, first_row - (window - 1)) / BLOCK : 0;
}
template <int BLOCK>
__device__ __forceinline__ int last_q_tile(int last_col, int window, int num_tiles) {
  return window > 0 ? min(num_tiles - 1, (last_col + window - 1) / BLOCK) : num_tiles - 1;
}

// ---------------------------------------------------------------------------
// bfloat16 helpers: accumulator fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats rounded to bf16 (nearest even, as torch's .to()) in one
// register, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// Mask a strip whose fragment rows are (row_of(0), row_of(8)) and whose
// columns start at first_col. transposed: the strip's rows are keys and its
// columns queries (dkv's s^T).
template <int N>
__device__ __forceinline__ void mask_strip(float (&s)[N / 8][4], int row0, int first_col,
                                           bool transposed, int window) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + (e >> 1) * 8, c = first_col + 8 * j + 2 * t + (e & 1);
      if (transposed ? dead(c, r, window) : dead(r, c, window)) s[j][e] = MASK_VALUE;
    }
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

// ---------------------------------------------------------------------------
// bfloat16 forward and dK/dV: TMA, mbarriers, wgmma, warp specialisation
// ---------------------------------------------------------------------------

constexpr int CONSUMERS = 2;                      // warpgroups that compute
constexpr int HOPPER_THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int STAGES = 2;                         // ring of tiles in flight
constexpr int FWD_BM = 128, FWD_BN = 128;         // forward: q rows a CTA, k tile width
constexpr int DKV_BK = 128, DKV_BQ = 64;          // dK/dV: keys a CTA, q tile rows
constexpr int DQ_BM = 128, DQ_BN = 128;           // dQ: q rows a CTA, k tile width
static_assert(DQ_BN == 128, "dQ's S and dP products are m64n128 wgmmas");

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
// Arrive once and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A [box rows, box cols] tile at (col c0, row c1) of the 2-D tensor map.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler may
// neither move their other uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// Swizzled shared tiles. A [rows, D] bf16 tile is stored as D / COLS parts
// side by side, each [rows, COLS] with ROW-byte rows swizzled in ROW-byte
// mode: the layout TMA writes and wgmma's descriptors read.
template <int D> struct Swz {
  static constexpr int ROW = D * 2 < 128 ? D * 2 : 128;
  static constexpr int COLS = ROW / 2;
  static constexpr int PARTS = D / COLS;
  static constexpr uint64_t MODE = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;  // descriptor layout
};

// Descriptor of a swizzled operand at `addr`: 8-row core groups ROW * 8
// bytes apart. The same stride goes in both offset fields: K-major operands
// read only the stride field, and MN-major ones here never span more than
// one part in N (each wgmma takes N = COLS), so whichever field the hardware
// reads for its K step holds the right value.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t group = (8 * Swz<D>::ROW) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | group << 16 | group << 32 |
         Swz<D>::MODE << 62;
}
// K-major operand (rows along M or N, D contiguous): the k-th 16-column step
// of the rows starting at `rows` (their address in part 0); parts are
// `part_bytes` apart. Inside a swizzled row the step is a plain 32-byte
// offset: the hardware applies the swizzle to the address it forms.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t rows, uint32_t part_bytes, int kk) {
  constexpr int steps = Swz<D>::COLS / 16;
  return smem_desc<D>(rows + (kk / steps) * part_bytes + (kk % steps) * 32);
}
// MN-major operand (B = the tile itself, rows along K, D along N): part
// `part` of N, the k-th step of 16 rows.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, uint32_t part_bytes, int part, int kk) {
  return smem_desc<D>(tile + part * part_bytes + kk * 16 * Swz<D>::ROW);
}

// The wgmma products (PTX wgmma.mma_async, bf16 in, f32 accumulate). In a
// warpgroup, thread 32w + lane holds accumulator rows 16w + lane/4 (+8),
// columns 8j + 2(lane%4) (+1) in d[j]: the mma.sync m16n8 layout, one warp
// per 16 rows.
// d[64, 64] (+)= A[64, 16] . B[16, 64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64, 128] (+)= A[64, 16] . B[16, 128]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64, N] += A[64, 16] . B[16, N]; A in registers (the m16n8k16 A-fragment
// layout per warp), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[2][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// e^x as ex2.approx(x * log2 e): three instructions with the subtraction
// before it, where expf takes about eight. Relative error ~1e-6 for the
// arguments here (|x| < ~20), far inside the bf16 rounding that p takes
// next; exp(0) is exactly 1 and exp(-1e30 - m) exactly 0, as with expf.
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// acc[64, D] += A[64, 16 (k step kk)] . B, B the MN-major tile at `tile`,
// one wgmma per part of D.
template <int D>
__device__ __forceinline__ void rs_step(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                        uint32_t tile, uint32_t part_bytes, int kk) {
  constexpr int NC = Swz<D>::COLS;
#pragma unroll
  for (int p = 0; p < Swz<D>::PARTS; ++p) {
    auto& chunk = *reinterpret_cast<float(*)[NC / 8][4]>(&acc[p * NC / 8]);
    const uint64_t db = desc_mn<D>(tile, part_bytes, p, kk);
    if constexpr (NC == 16) wgmma_rs_n16(chunk, a, db);
    else if constexpr (NC == 32) wgmma_rs_n32(chunk, a, db);
    else wgmma_rs_n64(chunk, a, db);
  }
}

// A fragments (bf16) of a [64, N] f32 accumulator, one per 16-column step:
// the accumulator layout is the A layout, so this is a cast and a pack.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&s)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// Load a [rows, D] tile at row `row` of a tensor map into its parts.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int rows, int row,
                                         uint32_t bar) {
#pragma unroll
  for (int p = 0; p < Swz<D>::PARTS; ++p)
    tma_load_2d(dst + p * rows * Swz<D>::ROW, map, bar, p * Swz<D>::COLS, row);
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// Byte offset `a` inside a swizzled part (from an 8-row boundary) as the
// hardware places it: the 16-byte chunk index XORed with the row bits.
template <int D>
__device__ __forceinline__ uint32_t swizzle(uint32_t a) {
  return a ^ (((a >> 7) & (Swz<D>::ROW / 16 - 1)) << 4);
}

// Write this warpgroup's [64, D] f32 accumulator (rows r scaled by s0,
// rows r + 8 by s1) as bf16 into the swizzled [64, D] region at `rows`
// (its part 0; parts `part_bytes` apart), ready for a TMA store.
template <int D>
__device__ __forceinline__ void stage_rows(unsigned char* rows, uint32_t part_bytes,
                                           const float (&acc)[D / 8][4], float s0, float s1) {
  using W = Swz<D>;
  const int lane = threadIdx.x % 32, r = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * (lane % 4);
    unsigned char* part = rows + (col / W::COLS) * part_bytes;
    const uint32_t a = r * W::ROW + (col % W::COLS) * 2;
    *reinterpret_cast<uint32_t*>(part + swizzle<D>(a)) = pack_bf16(acc[n][0] * s0, acc[n][1] * s0);
    *reinterpret_cast<uint32_t*>(part + swizzle<D>(a + 8 * W::ROW)) =
        pack_bf16(acc[n][2] * s1, acc[n][3] * s1);
  }
}

// After stage_rows by the whole warpgroup: one thread stores each staged
// [64, D] region (shared address `rows[i]`) to row `row` of `maps[i]`, and
// waits until shared memory has been read; the writes to global memory
// finish on their own while the CTA exits and the next one starts.
template <int D, int N>
__device__ __forceinline__ void store_staged(const CUtensorMap* const (&maps)[N],
                                             const uint32_t (&rows)[N], uint32_t part_bytes,
                                             int row) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // st.shared -> TMA
  // Named barrier 1 or 2 (0 is __syncthreads): this warpgroup's 128 threads.
  asm volatile("bar.sync %0, 128;\n" ::"r"(threadIdx.x / 128) : "memory");
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int p = 0; p < Swz<D>::PARTS; ++p)
        tma_store_2d(maps[i], rows[i] + p * part_bytes, p * Swz<D>::COLS, row);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// Shared memory of each kernel: tiles 1024-byte aligned (the 128-byte
// swizzle repeats every 8 rows of 128 bytes), then the mbarriers.
template <int D> struct FwdSmem {
  static constexpr uint32_t Q_BYTES = FWD_BM * D * 2, KV_BYTES = FWD_BN * D * 2;
  static constexpr uint32_t q = 0, k = Q_BYTES, v = k + STAGES * KV_BYTES;
  static constexpr uint32_t bars = v + STAGES * KV_BYTES;  // q, full_k[], full_v[], empty[]
  static constexpr size_t bytes = bars + 8 * (1 + 3 * STAGES) + 1024;  // + alignment slack
};
template <int D> struct DkvSmem {
  static constexpr uint32_t KV_BYTES = DKV_BK * D * 2, Q_BYTES = DKV_BQ * D * 2;
  static constexpr uint32_t ROW_BYTES = DKV_BQ * sizeof(float);
  static constexpr uint32_t k = 0, v = KV_BYTES, q = 2 * KV_BYTES, g = q + STAGES * Q_BYTES;
  static constexpr uint32_t lse = g + STAGES * Q_BYTES, delta = lse + STAGES * ROW_BYTES;
  static constexpr uint32_t bars = delta + STAGES * ROW_BYTES;  // kv, full[], empty[]
  static constexpr uint32_t STAGE_TX = 2 * Q_BYTES + 2 * ROW_BYTES;
  static constexpr size_t bytes = bars + 8 * (1 + 2 * STAGES) + 1024;
};
template <int D> struct DqSmem {
  static constexpr uint32_t Q_BYTES = DQ_BM * D * 2, KV_BYTES = DQ_BN * D * 2;
  static constexpr uint32_t q = 0, g = Q_BYTES, k = 2 * Q_BYTES, v = k + STAGES * KV_BYTES;
  static constexpr uint32_t bars = v + STAGES * KV_BYTES;  // qg, full[], empty[]
  static constexpr size_t bytes = bars + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t aligned_smem_base(const unsigned char* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tout,
               float* __restrict__ lse, int S, int H, int group, int window) {
  using L = FwdSmem<D>;
  using W = Swz<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t bar_q = base + L::bars;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * STAGES, empty = full_v + 8 * STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest k walks first
  const int bh = blockIdx.y;
  const int first_row = qt * FWD_BM;
  const int kt_lo = first_k_tile<FWD_BN>(first_row, window);
  const int num_k_tiles = (first_row + FWD_BM - 1) / FWD_BN - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CONSUMERS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      tma_tile<D>(base + L::q, &tq, FWD_BM, bh * S + first_row, bar_q);
      const int kv0 = kv_row(bh, H, group) * S;
      for (int i = 0; i < num_k_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        const int row = kv0 + (kt_lo + i) * FWD_BN;
        mbar_expect_tx(full_k + 8 * s, L::KV_BYTES);
        tma_tile<D>(base + L::k + s * L::KV_BYTES, &tk, FWD_BN, row, full_k + 8 * s);
        mbar_expect_tx(full_v + 8 * s, L::KV_BYTES);
        tma_tile<D>(base + L::v + s * L::KV_BYTES, &tv, FWD_BN, row, full_v + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: rows [64cw, 64cw + 64)
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int wg_row = first_row + 64 * cw;
  const int row0 = wg_row + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const uint32_t q_rows = base + L::q + 64 * cw * W::ROW;

  float o[D / 8][4];
  zero(o);
  float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.f, l1 = 0.f;
  mbar_wait(bar_q, 0);

  for (int i = 0; i < num_k_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t phase = (i / STAGES) & 1;
    const int first_col = (kt_lo + i) * FWD_BN;
    const uint32_t k_tile = base + L::k + s * L::KV_BYTES;
    const uint32_t v_tile = base + L::v + s * L::KV_BYTES;

    float sc[FWD_BN / 8][4];
    mbar_wait(full_k + 8 * s, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(sc, desc_k<D>(q_rows, FWD_BM * W::ROW, kk),
                    desc_k<D>(k_tile, FWD_BN * W::ROW, kk), kk);
    wgmma_commit();
    wgmma_wait();
    keep(sc);
    if (!tile_full(wg_row, 64, first_col, FWD_BN, window))
      mask_strip<FWD_BN>(sc, row0, first_col, false, window);

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < FWD_BN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = exp_approx(m0 - mx0), c1 = exp_approx(m1 - mx1);
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int j = 0; j < FWD_BN / 8; ++j) {
      sc[j][0] = exp_approx(sc[j][0] - mx0);
      sc[j][1] = exp_approx(sc[j][1] - mx0);
      sc[j][2] = exp_approx(sc[j][2] - mx1);
      sc[j][3] = exp_approx(sc[j][3] - mx1);
      r0 += sc[j][0] + sc[j][1];
      r1 += sc[j][2] + sc[j][3];
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
    uint32_t pa[FWD_BN / 16][4];  // p in bf16 for P.V, as the TPU kernel does
    pack_a<FWD_BN>(pa, sc);

    mbar_wait(full_v + 8 * s, phase);
    keep(o);
    keep(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FWD_BN / 16; ++kk) rs_step<D>(o, pa[kk], v_tile, FWD_BN * W::ROW, kk);
    wgmma_commit();
    wgmma_wait();
    keep(o);
    keep(pa);
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
  }

  // The output goes out through this warpgroup's q rows, which its last
  // S product has finished reading, and one TMA store.
  stage_rows<D>(smem_raw + (q_rows - smem_u32(smem_raw)), FWD_BM * W::ROW, o,
                1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f));
  const CUtensorMap* const maps[1] = {&tout};
  const uint32_t rows[1] = {q_rows};
  store_staged<D>(maps, rows, FWD_BM * W::ROW, bh * S + wg_row);
  if ((lane & 3) == 0) {
    lse[static_cast<size_t>(bh) * S + row0] = m0 + logf(l0 + 1e-30f);
    lse[static_cast<size_t>(bh) * S + row0 + 8] = m1 + logf(l1 + 1e-30f);
  }
}

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_dkv_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
               int S, int H, int group, int window) {
  using L = DkvSmem<D>;
  using W = Swz<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_kv = base + L::bars;
  const uint32_t full = bar_kv + 8, empty = full + 8 * STAGES;

  const int kt = blockIdx.x;  // k tile 0 walks the most q tiles: first
  const int bh = blockIdx.y;
  const int first_col = kt * DKV_BK;
  const int qt_lo = first_col / DKV_BQ;
  const int num_q_tiles =
      last_q_tile<DKV_BQ>(first_col + DKV_BK - 1, window, S / DKV_BQ) - qt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const int kv0 = kv_row(bh, H, group) * S + first_col;
      mbar_expect_tx(bar_kv, 2 * L::KV_BYTES);
      tma_tile<D>(base + L::k, &tk, DKV_BK, kv0, bar_kv);
      tma_tile<D>(base + L::v, &tv, DKV_BK, kv0, bar_kv);
      for (int i = 0; i < num_q_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        const int row = bh * S + (qt_lo + i) * DKV_BQ;
        mbar_expect_tx(full + 8 * s, L::STAGE_TX);
        tma_tile<D>(base + L::q + s * L::Q_BYTES, &tq, DKV_BQ, row, full + 8 * s);
        tma_tile<D>(base + L::g + s * L::Q_BYTES, &tg, DKV_BQ, row, full + 8 * s);
        bulk_load(base + L::lse + s * L::ROW_BYTES, lse + row, L::ROW_BYTES, full + 8 * s);
        bulk_load(base + L::delta + s * L::ROW_BYTES, delta + row, L::ROW_BYTES, full + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: keys [64cw, 64cw + 64)
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, t = lane & 3;
  const int first_key = first_col + 64 * cw;
  const int key0 = first_key + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
  const uint32_t k_rows = base + L::k + 64 * cw * W::ROW;
  const uint32_t v_rows = base + L::v + 64 * cw * W::ROW;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  mbar_wait(bar_kv, 0);

  for (int i = 0; i < num_q_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t phase = (i / STAGES) & 1;
    const int first_row = (qt_lo + i) * DKV_BQ;
    const uint32_t q_tile = base + L::q + s * L::Q_BYTES;
    const uint32_t g_tile = base + L::g + s * L::Q_BYTES;
    const float* cL = reinterpret_cast<const float*>(smem + L::lse + s * L::ROW_BYTES);
    const float* cDelta = reinterpret_cast<const float*>(smem + L::delta + s * L::ROW_BYTES);

    mbar_wait(full + 8 * s, phase);
    // Transposed strips: s^T = k.q^T, dp^T = v.g^T; rows are keys.
    float pt[DKV_BQ / 8][4], dst[DKV_BQ / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(pt, desc_k<D>(k_rows, DKV_BK * W::ROW, kk),
                   desc_k<D>(q_tile, DKV_BQ * W::ROW, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dst, desc_k<D>(v_rows, DKV_BK * W::ROW, kk),
                   desc_k<D>(g_tile, DKV_BQ * W::ROW, kk), kk);
    wgmma_commit();
    wgmma_wait();
    keep(pt);
    keep(dst);
    if (!tile_full(first_row, DKV_BQ, first_key, 64, window))
      mask_strip<DKV_BQ>(pt, key0, first_row, true, window);
#pragma unroll
    for (int j = 0; j < DKV_BQ / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(cL + 8 * j + 2 * t);
      const float2 d = *reinterpret_cast<const float2*>(cDelta + 8 * j + 2 * t);
      pt[j][0] = exp_approx(pt[j][0] - l.x);  // p^T = exp(s^T - lse)
      pt[j][1] = exp_approx(pt[j][1] - l.y);
      pt[j][2] = exp_approx(pt[j][2] - l.x);
      pt[j][3] = exp_approx(pt[j][3] - l.y);
      dst[j][0] = pt[j][0] * (dst[j][0] - d.x);  // ds^T = p^T * (dp^T - delta)
      dst[j][1] = pt[j][1] * (dst[j][1] - d.y);
      dst[j][2] = pt[j][2] * (dst[j][2] - d.x);
      dst[j][3] = pt[j][3] * (dst[j][3] - d.y);
    }
    uint32_t pa[DKV_BQ / 16][4], da[DKV_BQ / 16][4];  // p^T and ds^T in bf16
    pack_a<DKV_BQ>(pa, pt);
    pack_a<DKV_BQ>(da, dst);
    keep(dv_acc);
    keep(dk_acc);
    keep(pa);
    keep(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk)  // dv += p^T.g
      rs_step<D>(dv_acc, pa[kk], g_tile, DKV_BQ * W::ROW, kk);
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk)  // dk += ds^T.q (q carries the scale)
      rs_step<D>(dk_acc, da[kk], q_tile, DKV_BQ * W::ROW, kk);
    wgmma_commit();
    wgmma_wait();
    keep(dv_acc);
    keep(dk_acc);
    keep(pa);
    keep(da);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // dk and dv go out through this warpgroup's k and v rows, which no
  // product reads any more, and TMA stores.
  stage_rows<D>(smem_raw + (k_rows - smem_u32(smem_raw)), DKV_BK * W::ROW, dk_acc, 1.f, 1.f);
  stage_rows<D>(smem_raw + (v_rows - smem_u32(smem_raw)), DKV_BK * W::ROW, dv_acc, 1.f, 1.f);
  const CUtensorMap* const maps[2] = {&tdk, &tdv};
  const uint32_t rows[2] = {k_rows, v_rows};
  store_staged<D>(maps, rows, DKV_BK * W::ROW, bh * S + first_key);
}

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_dq_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const __grid_constant__ CUtensorMap tdq, int S, int H, int group, int window,
              float scale) {
  using L = DqSmem<D>;
  using W = Swz<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t bar_qg = base + L::bars;
  const uint32_t full = bar_qg + 8, empty = full + 8 * STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest k walks first
  const int bh = blockIdx.y;
  const int first_row = qt * DQ_BM;
  // The k walk: from the first tile the CTA's first row sees to the one
  // holding its last row's diagonal.
  const int kt_lo = first_k_tile<DQ_BN>(first_row, window);
  const int num_k_tiles = (first_row + DQ_BM - 1) / DQ_BN - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_qg, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_qg, 2 * L::Q_BYTES);
      tma_tile<D>(base + L::q, &tq, DQ_BM, bh * S + first_row, bar_qg);
      tma_tile<D>(base + L::g, &tg, DQ_BM, bh * S + first_row, bar_qg);
      const int kv0 = kv_row(bh, H, group) * S;
      for (int i = 0; i < num_k_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        const int row = kv0 + (kt_lo + i) * DQ_BN;
        mbar_expect_tx(full + 8 * s, 2 * L::KV_BYTES);
        tma_tile<D>(base + L::k + s * L::KV_BYTES, &tk, DQ_BN, row, full + 8 * s);
        tma_tile<D>(base + L::v + s * L::KV_BYTES, &tv, DQ_BN, row, full + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: rows [64cw, 64cw + 64)
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int wg_row = first_row + 64 * cw;
  const int row0 = wg_row + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const uint32_t q_rows = base + L::q + 64 * cw * W::ROW;
  const uint32_t g_rows = base + L::g + 64 * cw * W::ROW;
  const size_t r0 = static_cast<size_t>(bh) * S + row0;
  const float lse0 = lse[r0], lse1 = lse[r0 + 8];
  const float delta0 = delta[r0], delta1 = delta[r0 + 8];

  float acc[D / 8][4];
  zero(acc);
  // The two warpgroups take turns at issuing S and dP (named barriers 3
  // and 4; 1 and 2 are each warpgroup's own), warpgroup 0 first, so that
  // one's exp and dS.K run under the other's products instead of both
  // waiting on the same ones.
  const int turn = 3 + cw, other = 4 - cw;
  auto my_turn = [&] { asm volatile("bar.sync %0, 256;\n" ::"r"(turn) : "memory"); };
  auto pass_turn = [&] { asm volatile("bar.arrive %0, 256;\n" ::"r"(other) : "memory"); };
  if (cw == 1) pass_turn();
  mbar_wait(bar_qg, 0);

  for (int i = 0; i < num_k_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t phase = (i / STAGES) & 1;
    const int first_col = (kt_lo + i) * DQ_BN;
    const uint32_t k_tile = base + L::k + s * L::KV_BYTES;
    const uint32_t v_tile = base + L::v + s * L::KV_BYTES;

    // A tile that none of this warpgroup's rows see (a window shorter than
    // the tile) is computed and masked to zero all the same: skipping it
    // would put the products in a branch of their own.
    float sc[DQ_BN / 8][4], dp[DQ_BN / 8][4];
    mbar_wait(full + 8 * s, phase);
    my_turn();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(sc, desc_k<D>(q_rows, DQ_BM * W::ROW, kk),
                    desc_k<D>(k_tile, DQ_BN * W::ROW, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(dp, desc_k<D>(g_rows, DQ_BM * W::ROW, kk),
                    desc_k<D>(v_tile, DQ_BN * W::ROW, kk), kk);
    wgmma_commit();
    pass_turn();
    wgmma_wait();
    keep(sc);
    keep(dp);
    if (!tile_full(wg_row, 64, first_col, DQ_BN, window))
      mask_strip<DQ_BN>(sc, row0, first_col, false, window);
#pragma unroll
    for (int j = 0; j < DQ_BN / 8; ++j) {  // sc becomes ds = p * (dp - delta)
      sc[j][0] = exp_approx(sc[j][0] - lse0) * (dp[j][0] - delta0);
      sc[j][1] = exp_approx(sc[j][1] - lse0) * (dp[j][1] - delta0);
      sc[j][2] = exp_approx(sc[j][2] - lse1) * (dp[j][2] - delta1);
      sc[j][3] = exp_approx(sc[j][3] - lse1) * (dp[j][3] - delta1);
    }
    uint32_t da[DQ_BN / 16][4];  // ds in bf16, as the TPU kernel casts it
    pack_a<DQ_BN>(da, sc);
    keep(acc);
    keep(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BN / 16; ++kk)  // dq += ds.k, k read MN-major
      rs_step<D>(acc, da[kk], k_tile, DQ_BN * W::ROW, kk);
    wgmma_commit();
    wgmma_wait();
    keep(acc);
    keep(da);
    if (lane == 0) mbar_arrive(empty + 8 * s);  // after ds.k: K is read twice
  }
  if (cw == 0) my_turn();  // the turn warpgroup 1 passed last

  // ds.k used the unscaled ds; 1/sqrt(D) lands once here, as on the TPU.
  // dq goes out through this warpgroup's q rows, which its last S product
  // has finished reading, and one TMA store.
  stage_rows<D>(smem_raw + (q_rows - smem_u32(smem_raw)), DQ_BM * W::ROW, acc, scale, scale);
  const CUtensorMap* const maps[1] = {&tdq};
  const uint32_t rows[1] = {q_rows};
  store_staged<D>(maps, rows, DQ_BM * W::ROW, bh * S + wg_row);
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
  for (int kt = first_k_tile<TILE>(first_row, window); kt <= qt; ++kt) {
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile<D>(sK, kbase + static_cast<size_t>(kt) * TILE * D);
    load_tile<D>(sV, vbase + static_cast<size_t>(kt) * TILE * D);
    __syncthreads();
    const int first_col = kt * TILE;
    const bool full = tile_full(first_row, TILE, first_col, TILE, window);

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

  const int qt_hi = last_q_tile<TILE>(first_col + TILE - 1, window, S / TILE);
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
    const bool full = tile_full(first_row, TILE, first_col, TILE, window);

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
  for (int kt = first_k_tile<TILE>(first_row, window); kt <= qt; ++kt) {
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile<D>(sK, kbase + static_cast<size_t>(kt) * TILE * D);
    load_tile<D>(sV, vbase + static_cast<size_t>(kt) * TILE * D);
    __syncthreads();
    const int first_col = kt * TILE;
    const bool full = tile_full(first_row, TILE, first_col, TILE, window);
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

#define LAUNCH(kernel, smem, grid, threads, stream, ...)               \
  do {                                                                 \
    cudaError_t err_ = launch_prepare(kernel, smem);                   \
    if (err_ != cudaSuccess) return err_;                              \
    kernel<<<grid, threads, smem, stream>>>(__VA_ARGS__);              \
    return cudaGetLastError();                                         \
  } while (0)

// cuTensorMapEncodeTiled, taken from the driver through the runtime so that
// the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a [rows, D] bf16 tensor read in [box_rows, COLS] boxes,
// swizzled as Swz<D> lays tiles out.
template <int D>
bool tile_map(CUtensorMap* map, const void* ptr, int rows, int box_rows) {
  using W = Swz<D>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {D * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(W::COLS), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = W::ROW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : W::ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v, void* out, void* lse,
                int bh, int S, int H, int group, int window, cudaStream_t stream) {
  if (dtype == 1) {
    CUtensorMap tq, tk, tv, tout;
    const int kv_rows = bh / group * S;
    if (!tile_map<D>(&tq, q, bh * S, FWD_BM) || !tile_map<D>(&tk, k, kv_rows, FWD_BN) ||
        !tile_map<D>(&tv, v, kv_rows, FWD_BN) || !tile_map<D>(&tout, out, bh * S, 64))
      return cudaErrorInvalidValue;
    LAUNCH(flash_fwd_bf16<D>, FwdSmem<D>::bytes, dim3(S / FWD_BM, bh), HOPPER_THREADS, stream,
           tq, tk, tv, tout, static_cast<float*>(lse), S, H, group, window);
  }
  LAUNCH(flash_fwd_f32<D>, F32Smem<D>::fwd, dim3(S / TILE, bh), THREADS, stream,
         static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(lse), S, H,
         group, window);
}

template <int D>
cudaError_t dkv(int dtype, const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, void* dk, void* dv, int bh, int S, int H,
                int group, int window, cudaStream_t stream) {
  if (dtype == 1) {
    CUtensorMap tq, tk, tv, tg, tdk, tdv;
    const int kv_rows = bh / group * S;
    if (!tile_map<D>(&tq, q, bh * S, DKV_BQ) || !tile_map<D>(&tg, g, bh * S, DKV_BQ) ||
        !tile_map<D>(&tk, k, kv_rows, DKV_BK) || !tile_map<D>(&tv, v, kv_rows, DKV_BK) ||
        !tile_map<D>(&tdk, dk, bh * S, 64) || !tile_map<D>(&tdv, dv, bh * S, 64))
      return cudaErrorInvalidValue;
    LAUNCH(flash_dkv_bf16<D>, DkvSmem<D>::bytes, dim3(S / DKV_BK, bh), HOPPER_THREADS, stream,
           tq, tk, tv, tg, static_cast<const float*>(lse), static_cast<const float*>(delta), tdk,
           tdv, S, H, group, window);
  }
  LAUNCH(flash_dkv_f32<D>, F32Smem<D>::dkv, dim3(S / TILE, bh), THREADS, stream,
         static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(g),
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<float*>(dk), static_cast<float*>(dv), S, H, group, window);
}

template <int D>
cudaError_t dq(int dtype, const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, void* dq_out, int bh, int S, int H,
               int group, int window, float scale, cudaStream_t stream) {
  if (dtype == 1) {
    CUtensorMap tq, tk, tv, tg, tdq;
    const int kv_rows = bh / group * S;
    if (!tile_map<D>(&tq, q, bh * S, DQ_BM) || !tile_map<D>(&tg, g, bh * S, DQ_BM) ||
        !tile_map<D>(&tk, k, kv_rows, DQ_BN) || !tile_map<D>(&tv, v, kv_rows, DQ_BN) ||
        !tile_map<D>(&tdq, dq_out, bh * S, 64))
      return cudaErrorInvalidValue;
    LAUNCH(flash_dq_bf16<D>, DqSmem<D>::bytes, dim3(S / DQ_BM, bh), HOPPER_THREADS, stream,
           tq, tk, tv, tg, static_cast<const float*>(lse), static_cast<const float*>(delta), tdq,
           S, H, group, window, scale);
  }
  LAUNCH(flash_dq_f32<D>, F32Smem<D>::dq, dim3(S / TILE, bh), THREADS, stream,
         static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(g),
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<float*>(dq_out), S, H, group, window, scale);
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

// S a multiple of 128 (the widest tile), and every flat row index an int
// (the TMA coordinates are 32-bit).
bool bad_args(int dtype, int bh, int S) {
  return (dtype != 0 && dtype != 1) || bh < 1 || bh > 65535 || S < 128 || S % 128 != 0 ||
         static_cast<long long>(bh) * S > 0x7fffffffLL;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the launch's
// cudaGetLastError() (0 on success); the kernels run asynchronously on
// `stream` and allocate nothing. Tensors are contiguous and 16-byte aligned.
extern "C" int flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                         void* out, void* lse, int bh, int seq, int num_q_heads, int group,
                         int window, void* stream) {
  if (bad_args(dtype, bh, seq)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  DISPATCH(head_dim, (fwd<D>(dtype, q, k, v, out, lse, bh, seq, num_q_heads, group, window, s)));
}

extern "C" int flash_dkv(int dtype, int head_dim, const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta, void* dk, void* dv,
                         int bh, int seq, int num_q_heads, int group, int window, void* stream) {
  if (bad_args(dtype, bh, seq)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  DISPATCH(head_dim, (dkv<D>(dtype, q, k, v, g, lse, delta, dk, dv, bh, seq, num_q_heads, group,
                             window, s)));
}

extern "C" int flash_dq(int dtype, int head_dim, const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta, void* dq_out, int bh,
                        int seq, int num_q_heads, int group, int window, float scale,
                        void* stream) {
  if (bad_args(dtype, bh, seq)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  DISPATCH(head_dim, (dq<D>(dtype, q, k, v, g, lse, delta, dq_out, bh, seq, num_q_heads, group,
                            window, scale, s)));
}
