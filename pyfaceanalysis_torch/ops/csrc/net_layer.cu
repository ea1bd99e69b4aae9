// One HiGSFA layer's product operand in one launch.
//
// Replaces no TPU kernel: the JAX package leaves a layer's switchboard
// gather, expansion, centring and bf16 operand rounding to XLA, which fuses
// them. In plain PyTorch (models/network.py apply_layer) they are about 13
// element-wise kernels a layer, each a round trip to device memory. This
// kernel writes the (B, F, D) float32 operand of the layer's product
// `bfd,fdo->bfo` directly:
//
//   x      the previous layer's product output read as the product left it,
//          (B, G, O) with any strides, clipped on load to [lo, hi] (torch's
//          clamp: NaN passes); for the first layer the (B, P) input rows
//          (G = 1, no clip). Input p of a row is x[b, p / O, p % O].
//   gather field f's input j is p = index[f, j] ((F, k) int64).
//   expand column c of a field comes from the column table (cols[c] packs
//          op << 28 | a << 14 | b; models/expansion.py Expansion.columns,
//          packed by ops/cuda_net_layer.py): a copy of input a or the
//          product of inputs a and b (qtK's triu pairs). A table of spow's
//          form (the k inputs, then their k spows; the wrapper takes spow
//          columns in no other) takes a loop of its own: columns j and
//          k + j of a field are input j and sign(v) * float(pow(double |v|,
//          expo)) of it.
//   centre minus mean[f, c] ((F, D), contiguous).
//   round  with bf16 on, to bfloat16 (nearest even) and back to float.
//
// Exactness: the same IEEE operations as the plain path, in its order.
// Every float multiply and subtract is an _rn intrinsic, so nothing is
// contracted into an FMA; |v|^expo rounds to the float that libdevice's
// double pow rounds to (torch's pow of a float64 tensor by a scalar,
// then __double2float_rn; pow_rounded below gets there by a shorter way
// for the exponent float32(0.8), checked on every float32, and takes
// libdevice's pow itself for any other); sign is torch's (0 < v) - (v < 0) (0
// for NaN and for both zeros); the bf16 rounding is __float2bfloat16_rn,
// which torch's float -> bfloat16 copy uses on this architecture. The
// operand is therefore bit-equal to the plain path's, and the product
// that reads it (the same einsum on an operand of the same shape, strides
// and dtype) returns the same bits. Never compile this file with
// --use_fast_math.
//
// Bound: bytes. A row reads its P inputs once and writes its F * D
// operand floats once (layer 1 of a detection net: 14 KB in, 32 KB out).
// A block owns R consecutive rows at a time (a tile): its threads first
// copy the tile's inputs into shared memory, walking (g, r, o) so that
// neighbouring threads read neighbouring addresses of both layouts (the
// einsum output keeps the R rows of one g contiguous, the input rows are
// contiguous) with kLoads loads in flight each, then write the tile's
// operand, R * F * D contiguous floats: neighbouring threads write
// neighbouring columns, 128-byte lines. The gather reads shared memory
// only, so a qtK head input, read by up to K columns, is read from device
// memory once. In a spow layer a thread takes one input and writes both
// of its columns, so the whole warp runs the pow. With libdevice's pow
// the spow layers were bound by double-precision work (0.46 ms at 8,192
// rows against 0.12 ms of bytes on an H100); pow_rounded's table and
// polynomial took them to 0.25 ms. The switchboard (as int32), the
// column table and the pow tables are in shared memory once per block;
// the blocks are persistent (as many as fit on the card) and walk the
// tiles. Divisions by run-time sizes are a multiply-high and a shift
// (Div). No allocation and no synchronisation with the host: the launch
// is captured into CUDA graphs as it is.
//
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes (ops/cuda_net_layer.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMul = 2;             // a column op; 0 is a copy
constexpr int kMaxRows = 32;        // rows in a tile
constexpr int kLoads = 8;           // global loads in flight per thread
constexpr int kMaxDevices = 64;
// Threads of a block, and the shared memory a block aims at when the
// launch chooses the rows of a tile: 512 threads were 5-40% faster than
// 256 at every layer and row count timed, targets of 32-96 KB within a
// few per cent of each other (an H100).
constexpr int kThreads = 512;
constexpr size_t kSmemTarget = 64 * 1024;

// n / d for 0 <= n < 2^31 and d >= 1 as (umulhi(n, m) + n) >> s.
struct Div {
  unsigned m, s;
};

Div make_div(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const uint64_t one = 1;
  return {static_cast<unsigned>(((one << 32) * ((one << s) - d)) / d + 1),
          s};
}

__device__ __forceinline__ unsigned divide(const Div& v, unsigned n) {
  return (__umulhi(n, v.m) + n) >> v.s;
}

struct Args {
  const float* x;
  long long sb, sg, so;             // x's strides, viewed (B, G, O)
  int O, P;                         // P = G * O inputs a row
  int clip;
  float lo, hi;
  const long long* index;           // (F, k)
  int F, k;
  const int* cols;                  // (D,) packed
  int D;
  const float* mean;                // (F, D) contiguous
  double expo;
  int bf16;
  float* out;                       // (B, F, D) contiguous
  int B, R;
  int pairs;                        // 1: spow (a thread per input)
  Div by_ro, by_o, by_fd, by_d, by_k, by_f;
};

__device__ __forceinline__ float finish(float v, float m, int bf16) {
  v = __fsub_rn(v, m);
  if (bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// float(pow(double a, expo)) for a >= 0, as the plain path rounds it. For
// expo = float32(0.8), the one exponent checked on every input, at a
// fraction of libdevice pow's double work: with a = m 2^e (m in [1, 2),
// c = 1 + i/128 for m's top 7 bits, m = c (1 + x), 0 <= x < 2^-7):
// a^expo = 2^(expo e) c^expo (1 + x)^expo, the first two from tables and
// the last a degree-6 binomial series in double (the first term left out
// is below 2^-56 of the value). That value is within about 2^-48 of the
// true power and libdevice's within 2^-52, so where both ends of
// [y (1 - 2^-44), y (1 + 2^-44)] round to the same float, that float is
// libdevice's rounded; otherwise (near a rounding boundary), and for 0,
// subnormals, inf and NaN, libdevice's pow itself. Equality with the
// plain path holds for every float32 input, checked exhaustively on the
// card (pfa_net_layer_spow_launch, tests/test_torch_net_layer.py). The
// bounds above rest on the series' terms at this exponent (at an exponent
// above 1 the first term left out can pass the slack), so every other
// exponent takes libdevice's pow.
constexpr double kPowSlack = 0x1p-44;
constexpr double kSweptExpo = static_cast<double>(0.8f);

struct PowTables {
  double scale[254];                // 2^(expo e), e = -126 .. 127
  double head[128];                 // (1 + i/128)^expo
  double inv[128];                  // 1 / (1 + i/128)
  double coef[7];                   // binomial(expo, j)
};

__device__ void fill_pow_tables(PowTables* t, double expo) {
  for (int i = threadIdx.x; i < 254; i += blockDim.x)
    t->scale[i] = exp2(expo * (i - 126));
  for (int i = threadIdx.x; i < 128; i += blockDim.x) {
    const double c = 1.0 + i / 128.0;
    t->head[i] = pow(c, expo);
    t->inv[i] = __drcp_rn(c);
  }
  if (threadIdx.x == 0) {
    double c = 1.0;
    for (int j = 0; j < 7; ++j) {
      t->coef[j] = c;
      c = c * (expo - j) / (j + 1);
    }
  }
}

__device__ __forceinline__ float pow_rounded(float a, double expo,
                                             const PowTables& t) {
  const unsigned bits = __float_as_uint(a);
  const int e = static_cast<int>(bits >> 23) - 127;
  if (expo == kSweptExpo && e >= -126 && e <= 127) {
    const unsigned man = bits & 0x7fffffu;
    const int i = man >> 16;
    const double m = __uint_as_float(man | 0x3f800000u);
    const double x = __fma_rn(m, t.inv[i], -1.0);
    double p = t.coef[6];
#pragma unroll
    for (int j = 5; j >= 0; --j) p = __fma_rn(p, x, t.coef[j]);
    const double y = __dmul_rn(t.scale[e + 126], __dmul_rn(t.head[i], p));
    const float lo = __double2float_rn(__dmul_rn(y, 1.0 - kPowSlack));
    const float hi = __double2float_rn(__dmul_rn(y, 1.0 + kPowSlack));
    if (lo == hi) return lo;
  }
  return __double2float_rn(pow(static_cast<double>(a), expo));
}

__device__ __forceinline__ float spow(float v, double expo,
                                      const PowTables& t) {
  const float s = static_cast<float>((0.0f < v) - (v < 0.0f));
  return __fmul_rn(s, pow_rounded(fabsf(v), expo, t));
}

__global__ void net_layer_kernel(const Args a) {
  extern __shared__ double smem_d[];
  PowTables* pow_t = reinterpret_cast<PowTables*>(smem_d);
  int* idx = reinterpret_cast<int*>(pow_t + 1);    // F * k
  int* col = idx + a.F * a.k;                       // D
  float* tile = reinterpret_cast<float*>(col + a.D);  // R * P
  if (a.pairs) fill_pow_tables(pow_t, a.expo);
  const unsigned n_idx = static_cast<unsigned>(a.F) * a.k;
  for (unsigned i0 = threadIdx.x; i0 < n_idx; i0 += kLoads * blockDim.x) {
    long long v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const unsigned i = i0 + u * blockDim.x;
      if (i < n_idx) v[u] = __ldg(a.index + i);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const unsigned i = i0 + u * blockDim.x;
      if (i < n_idx) idx[i] = static_cast<int>(v[u]);
    }
  }
  for (int i = threadIdx.x; i < a.D; i += blockDim.x) col[i] = a.cols[i];
  const int tiles = (a.B + a.R - 1) / a.R;
  const unsigned n_in = static_cast<unsigned>(a.P) * a.R;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b0 = t * a.R;
    const unsigned rows = min(a.R, a.B - b0);
    __syncthreads();  // the tables are in, the previous tile is written
    // kLoads loads in flight per thread, then their stores.
    for (unsigned i0 = threadIdx.x; i0 < n_in; i0 += kLoads * blockDim.x) {
      float v[kLoads];
      unsigned at[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const unsigned i = i0 + u * blockDim.x;
        at[u] = ~0u;
        if (i < n_in) {
          const unsigned g = divide(a.by_ro, i);
          const unsigned ro = i - g * (a.R * a.O);
          const unsigned r = divide(a.by_o, ro);
          const unsigned o = ro - r * a.O;
          if (r < rows) {
            v[u] = __ldg(a.x + (b0 + r) * a.sb + g * a.sg + o * a.so);
            at[u] = r * a.P + g * a.O + o;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (at[u] != ~0u) {
          float w = v[u];
          if (a.clip && !isnan(w)) w = fminf(fmaxf(w, a.lo), a.hi);
          tile[at[u]] = w;
        }
      }
    }
    __syncthreads();
    float* out = a.out + static_cast<size_t>(b0) * a.F * a.D;
    if (a.pairs) {
      // Columns j and k + j of a field both come from its input j.
      const unsigned n = rows * a.F * a.k;
      for (unsigned u = threadIdx.x; u < n; u += blockDim.x) {
        const unsigned q = divide(a.by_k, u);        // r * F + f
        const unsigned j = u - q * a.k;
        const unsigned r = divide(a.by_f, q);
        const unsigned f = q - r * a.F;
        const float v = tile[r * a.P + idx[f * a.k + j]];
        const float* m = a.mean + static_cast<size_t>(f) * a.D;
        float* o = out + static_cast<size_t>(q) * a.D;
        o[j] = finish(v, __ldg(m + j), a.bf16);
        o[a.k + j] = finish(spow(v, a.expo, *pow_t), __ldg(m + a.k + j),
                            a.bf16);
      }
    } else {
      const unsigned n = rows * a.F * a.D;
      for (unsigned u = threadIdx.x; u < n; u += blockDim.x) {
        const unsigned r = divide(a.by_fd, u);
        const unsigned fc = u - r * (a.F * a.D);
        const unsigned f = divide(a.by_d, fc);
        const unsigned c = fc - f * a.D;
        const float* row = tile + r * a.P;
        const int* in = idx + f * a.k;
        const int op = col[c];
        float v = row[in[(op >> 14) & 0x3fff]];
        if ((op >> 28) == kMul) v = __fmul_rn(v, row[in[op & 0x3fff]]);
        out[u] = finish(v, __ldg(a.mean + fc), a.bf16);
      }
    }
  }
}

__global__ void spow_kernel(const float* __restrict__ x,
                            float* __restrict__ out, long long n,
                            double expo) {
  __shared__ PowTables t;
  fill_pow_tables(&t, expo);
  __syncthreads();
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = spow(x[i], expo, t);
}

int g_smem_set[kMaxDevices];
int g_sms[kMaxDevices];

}  // namespace

// Shared memory one block takes at `rows` rows a tile.
extern "C" size_t pfa_net_layer_smem(int P, int F, int k, int D, int rows) {
  return sizeof(PowTables) +
         (static_cast<size_t>(F) * k + D + static_cast<size_t>(rows) * P) *
             sizeof(float);
}

// The layer kernel's spow column, sign(x) * float(pow(double |x|, expo)),
// on n floats: for checks that hold it against the plain path.
extern "C" int pfa_net_layer_spow_launch(const float* x, float* out,
                                         long long n, double expo,
                                         void* stream) {
  if (n == 0) return 0;
  spow_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, expo);
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok;
// cudaErrorInvalidConfiguration when one row does not fit a block's shared
// memory). A tile takes as many rows as fit kSmemTarget (at least one; at
// most kMaxRows, and few enough that the tiles outnumber twice the SMs).
extern "C" int pfa_net_layer_launch(
    const float* x, long long sb, long long sg, long long so, int G, int O,
    int clip, float lo, float hi, const long long* index, int F, int k,
    const int* cols, int D, int pairs, const float* mean,
    double expo, int bf16, float* out, int B, void* stream) {
  if (B == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int P = G * O;
  const size_t fixed = pfa_net_layer_smem(P, F, k, D, 0);
  const size_t per_row = static_cast<size_t>(P) * sizeof(float);
  int R = kSmemTarget > fixed
              ? static_cast<int>((kSmemTarget - fixed) / per_row) : 1;
  const int spread = (B + 2 * g_sms[dev] - 1) / (2 * g_sms[dev]);
  R = std::max(1, std::min({R, kMaxRows, spread}));
  const size_t smem = pfa_net_layer_smem(P, F, k, D, R);
  if (smem > 48 * 1024 && g_smem_set[dev] < static_cast<int>(smem)) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(net_layer_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set[dev] = optin;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, net_layer_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  Args a;
  a.x = x;
  a.sb = sb;
  a.sg = sg;
  a.so = so;
  a.O = O;
  a.P = P;
  a.clip = clip;
  a.lo = lo;
  a.hi = hi;
  a.index = index;
  a.F = F;
  a.k = k;
  a.cols = cols;
  a.D = D;
  a.mean = mean;
  a.expo = expo;
  a.bf16 = bf16;
  a.out = out;
  a.B = B;
  a.R = R;
  a.pairs = pairs;
  a.by_ro = make_div(static_cast<unsigned>(R * O));
  a.by_o = make_div(static_cast<unsigned>(O));
  a.by_fd = make_div(static_cast<unsigned>(F * D));
  a.by_d = make_div(static_cast<unsigned>(D));
  a.by_k = make_div(static_cast<unsigned>(k));
  a.by_f = make_div(static_cast<unsigned>(F));
  const int tiles = (B + R - 1) / R;
  const int grid = std::min(tiles, per_sm * g_sms[dev]);
  net_layer_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
