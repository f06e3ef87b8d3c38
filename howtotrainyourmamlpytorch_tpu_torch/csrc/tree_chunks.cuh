// The walk over a parameter tree that both fused-update kernels share:
// csrc/fused_sgd.cu (B1) and csrc/fused_sgd_bwd.cu (B2). Each of them is one
// launch over L leaves that lie where PyTorch put them, with nothing packed
// and nothing copied around the launch.
//
// The leaf table (Table<N>) travels by value in the launch's parameter space
// (__grid_constant__): per leaf its operand pointers a, b (p, g for B1; ct,
// g for B2), its output pointer, a pointer to its f32 learning rate, its
// element count and vector count, and its first chunk; and per block the
// leaf its run of chunks starts in, so that a block finds its first leaf with
// one read instead of a scan. So no host-to-device copy and no other launch
// comes before the kernel.
//
// Two capacities. Table<kSmallLeaves> (64 leaves, 3,096 bytes) fits the
// classic 4 KB parameter space: the VGG trees take it, and their launches
// are what they were. Table<kLargeLeaves> (256 leaves, 11,808 bytes, 16-bit
// start leaves) takes deeper trees (ResNet-12: 86 leaves, DenseNet-12: 85).
// It travels in the larger parameter space Hopper gets from CUDA 12.1 on
// (up to 32,764 bytes on sm_70 and newer). Each kernel's host function
// launches with the smaller table that holds the tree (small_table); a tree
// of more than kLargeLeaves leaves is refused.
//
// Chunks. Every leaf is cut into chunks of kChunkBytes per operand: kVecs
// 16-byte vectors for each of the block's 256 threads (vector u * 256 + t
// of the chunk is thread t's u-th). No chunk crosses a leaf. A leaf whose
// operands and output start on 16-byte boundaries has a vector body and a
// scalar rest (fewer elements than one vector, taken by chunk 0); any other
// leaf is read element by element, kVecs * V * 256 elements per chunk. Both
// kinds are updated by the same launch. The split is made here, on the host
// (fill_table), and nowhere else: the wrapper only sizes B2's scratch by
// asking for the chunk count (fused_sgd_chunks).
//
// Work split. Block b takes the run of chunks [b * run, (b + 1) * run), run
// chosen on the host so that about kCtasPerSm blocks per SM (at most
// kMaxGrid) cover the list; at the main paths' tree that is one chunk per
// block. At this size the time is latency, not bandwidth, and the code is
// part of it: after the L2 is flushed every SM fetches the kernel's
// instructions cold. So a thread issues all kVecs 16-byte loads per operand
// of its chunk before it uses any, a chunk costs one leaf lookup and a short
// straight path (32-bit index arithmetic, one block-uniform test), and the
// scalar rest and element-wise leaves live out of line in scalar_part. (A
// design that staged each chunk in shared memory with Hopper's bulk
// asynchronous copy ran no faster at the main paths' tree; PERF.md.)
//
// Interface (host): fill_table() reads kRecordWords uint64 words per leaf
// (a, b, out, lr, numel: the records ops/fused_update.py::_prepare builds;
// every operand contiguous) and derives the split.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tree {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmallLeaves = 64;
constexpr int kLargeLeaves = 256;
constexpr int kVecs = 4;                          // 16-byte vectors per thread per chunk
constexpr int kChunkVectors = kVecs * kThreads;
constexpr int kChunkBytes = kChunkVectors * 16;  // per operand
constexpr int kCtasPerSm = 2;
constexpr int kMaxGrid = 2 * 132;
constexpr int kRecordWords = 5;  // a, b, out, lr, numel
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Leaf {
  const void* a;
  const void* b;
  void* out;
  const float* lr;
  int32_t n;     // elements
  int32_t vecs;  // 16-byte vectors in the body; -1: read element by element
};

template <int N>
struct Table {
  static constexpr int kCapacity = N;
  using StartLeaf = typename std::conditional<(N <= kSmallLeaves), uint8_t, uint16_t>::type;
  Leaf leaf[N];
  int32_t first_chunk[N + 1];     // [n_leaves] = n_chunks
  StartLeaf start_leaf[kMaxGrid];  // the leaf of each block's first chunk
  int32_t n_leaves;
  int32_t n_chunks;
  int32_t run;  // chunks per block: block b takes [b * run, min((b + 1) * run, n_chunks))
};
// B2 passes two pointers beside it
static_assert(sizeof(Table<kSmallLeaves>) + 16 <= 4096, "the small table must fit the classic 4 KB parameter space");
static_assert(sizeof(Table<kLargeLeaves>) + 16 <= 32764, "the large table must fit the 32,764-byte parameter space");

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The table a launch over n_leaves leaves takes: the small one where it holds
// them (its launch stays in the classic 4 KB parameter space), else the large
// one; fill_table refuses a tree of more than kLargeLeaves leaves.
inline bool small_table(int n_leaves) { return n_leaves <= kSmallLeaves; }

// Chunks per block: as few as let kCtasPerSm blocks per SM (at most
// kMaxGrid) cover the list.
inline int run_for(int n_chunks) {
  static int sms[kMaxDevices] = {};
  int device = 0;
  int count = 132;
  if (cudaGetDevice(&device) == cudaSuccess && device < kMaxDevices) {
    if (sms[device] == 0) cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (sms[device] > 0) count = sms[device];
  }
  int blocks = count * kCtasPerSm;
  if (blocks > kMaxGrid) blocks = kMaxGrid;
  return (n_chunks + blocks - 1) / blocks;
}

// Fills the table from the records and makes the split: a leaf whose a, b
// and out start on 16-byte boundaries gets a vector body of n / V vectors
// and ceil(vectors / kChunkVectors) chunks (chunk 0 also takes the rest),
// any other leaf ceil(n / (kChunkVectors * V)) chunks, every leaf at least
// one. Returns the grid, or 0 when the records are out of range.
template <int N>
inline int fill_table(const uint64_t* records, int n_leaves, int element_size, Table<N>* tab) {
  if (n_leaves <= 0 || n_leaves > N) return 0;
  const int64_t vec = 16 / element_size;
  int64_t n_chunks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const uint64_t* r = records + static_cast<int64_t>(i) * kRecordWords;
    if (r[4] >= (1ull << 31)) return 0;
    const int64_t n = static_cast<int64_t>(r[4]);
    const bool vector = ((r[0] | r[1] | r[2]) & 15) == 0;
    const int64_t vecs = vector ? n / vec : -1;
    const int64_t units = vector ? vecs : (n + vec - 1) / vec;  // vectors, or elements in vectors' worth
    tab->leaf[i] = Leaf{reinterpret_cast<const void*>(r[0]), reinterpret_cast<const void*>(r[1]),
                        reinterpret_cast<void*>(r[2]), reinterpret_cast<const float*>(r[3]),
                        static_cast<int32_t>(n), static_cast<int32_t>(vecs)};
    tab->first_chunk[i] = static_cast<int32_t>(n_chunks);
    const int64_t chunks = (units + kChunkVectors - 1) / kChunkVectors;
    n_chunks += chunks > 0 ? chunks : 1;
  }
  tab->first_chunk[n_leaves] = static_cast<int32_t>(n_chunks);
  tab->n_leaves = n_leaves;
  tab->n_chunks = static_cast<int32_t>(n_chunks);
  tab->run = run_for(tab->n_chunks);
  const int grid = (tab->n_chunks + tab->run - 1) / tab->run;
  int leaf = 0;
  for (int b = 0; b < grid; ++b) {
    while (tab->first_chunk[leaf + 1] <= b * tab->run) ++leaf;
    tab->start_leaf[b] = static_cast<typename Table<N>::StartLeaf>(leaf);
  }
  return grid;
}

// ---------------------------------------------------------------------------
// element types: f32 math on float32 or bfloat16 storage
// ---------------------------------------------------------------------------

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float load(const void* base, int i) {
    return __ldg(static_cast<const float*>(base) + i);
  }
  static __device__ __forceinline__ void store(void* base, int i, float v) {
    static_cast<float*>(base)[i] = v;
  }
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float load(const void* base, int i) {
    const unsigned bits = __ldg(static_cast<const unsigned short*>(base) + i);
    return __uint_as_float(bits << 16);  // exact
  }
  static __device__ __forceinline__ void store(void* base, int i, float v) {
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // the element at the lower address is the low half
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// ---------------------------------------------------------------------------
// reductions (fixed trees: the same inputs give the same bits every run)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(kFull, v, offset);
  return v;
}

// The block's sum, valid in thread 0: 5 shuffle levels in each warp, then 3
// over the 8 warp sums. Every thread of the block must call it; it ends
// with the block synchronised.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (warp == 0) {
    s = lane < kWarps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int offset = kWarps / 2; offset > 0; offset >>= 1) s += __shfl_xor_sync(kFull, s, offset);
  }
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------------------
// the chunk walk
// ---------------------------------------------------------------------------

// the leaf of chunk c, searching forward from leaf l (chunks are walked in
// increasing order)
template <class Tab>
__device__ __forceinline__ int leaf_of(const Tab& tab, int c, int l) {
  while (tab.first_chunk[l + 1] <= c) ++l;
  return l;
}

// body vectors of chunk k of a leaf: 0 to kChunkVectors
__device__ __forceinline__ int chunk_vectors(const Leaf& leaf, int k) {
  const int left = leaf.vecs - k * kChunkVectors;
  return left <= 0 ? 0 : (left < kChunkVectors ? left : kChunkVectors);
}

// element index of vector j of chunk k of a leaf
template <typename T>
__device__ __forceinline__ int vector_origin(int k, int j) {
  return (k * kChunkVectors + j) * Elem<T>::kVec;
}

template <class Op, typename T>
__device__ __forceinline__ float scalar_update(const Leaf& leaf, int i, float lr, float acc) {
  const float a = Elem<T>::load(leaf.a, i);
  const float b = Elem<T>::load(leaf.b, i);
  Elem<T>::store(leaf.out, i, Op::out(lr, a, b));
  if constexpr (Op::kReduce) acc = fmaf(a, b, acc);
  return acc;
}

// Thread t's scalar elements of chunk k of a leaf: in a vector leaf's chunk
// 0 its part of the rest (fewer than one vector), in a leaf read element by
// element kVecs * V elements. Out of line: few chunks need it, and one copy
// of its code keeps the kernel short.
template <class Op, typename T>
__device__ __noinline__ float scalar_part(const Leaf leaf, int k, float lr, float acc) {
  constexpr int V = Elem<T>::kVec;
  const int t = threadIdx.x;
  if (leaf.vecs >= 0) {
    if (t < leaf.n - leaf.vecs * V) acc = scalar_update<Op, T>(leaf, leaf.vecs * V + t, lr, acc);
  } else {
    for (int j = 0; j < kVecs * V; ++j) {
      const int i = (k * kVecs * V + j) * kThreads + t;
      if (i < leaf.n) acc = scalar_update<Op, T>(leaf, i, lr, acc);
    }
  }
  return acc;
}

// Thread t's part of chunk k of a leaf (nvec body vectors), given its
// vectors av[u], bv[u] (vector u * 256 + t): the vectors, then the scalar
// part where the chunk has one. Returns the thread's sum of a * b over
// them (Op::kReduce), a chain of at most kVecs * V + 1 fused multiply-adds.
template <class Op, typename T>
__device__ __forceinline__ float chunk_update(const Leaf& leaf, int k, int nvec, float lr, const uint4 (&av)[kVecs],
                                              const uint4 (&bv)[kVecs]) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  float acc = 0.0f;
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int j = u * kThreads + threadIdx.x;
    if (j < nvec) {
      float a[V], b[V], o[V];
      E::unpack(av[u], a);
      E::unpack(bv[u], b);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        o[e] = Op::out(lr, a[e], b[e]);
        if constexpr (Op::kReduce) acc = fmaf(a[e], b[e], acc);
      }
      *reinterpret_cast<uint4*>(static_cast<T*>(leaf.out) + vector_origin<T>(k, j)) = E::pack(o);
    }
  }
  if (leaf.vecs < 0 || (k == 0 && leaf.n > leaf.vecs * V)) acc = scalar_part<Op, T>(leaf, k, lr, acc);
  return acc;
}

// Block b's run of chunks: for each, a thread issues its kVecs loads per
// operand, then computes and stores; Op::kReduce writes the block sum of
// a * b of every chunk c to partial[c].
template <class Op, typename T, class Tab>
__device__ __forceinline__ void walk(const Tab& tab, float* partial) {
  // the start leaf first: with the run's bounds it is all a block's first
  // data loads wait for, besides that leaf's entry
  int l = tab.start_leaf[blockIdx.x];
  const int c0 = blockIdx.x * tab.run;
  const int c1 = min(c0 + tab.run, tab.n_chunks);
  const int t = threadIdx.x;
  int c = c0;
  do {  // every block has a chunk: no test before the first one's loads
    if (c > c0) l = leaf_of(tab, c, l);  // chunk c0 lies in the start leaf
    const Leaf& leaf = tab.leaf[l];
    const int k = c - tab.first_chunk[l];
    const int nvec = chunk_vectors(leaf, k);
    const T* a = static_cast<const T*>(leaf.a);
    const T* b = static_cast<const T*>(leaf.b);
    uint4 av[kVecs], bv[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int j = u * kThreads + t;
      av[u] = bv[u] = make_uint4(0, 0, 0, 0);
      if (j < nvec) {
        av[u] = __ldg(reinterpret_cast<const uint4*>(a + vector_origin<T>(k, j)));
        bv[u] = __ldg(reinterpret_cast<const uint4*>(b + vector_origin<T>(k, j)));
      }
    }
    const float acc = chunk_update<Op, T>(leaf, k, nvec, __ldg(leaf.lr), av, bv);
    if constexpr (Op::kReduce) {
      const float sum = block_sum(acc);
      if (t == 0) partial[c] = sum;
    }
  } while (++c < c1);
}

// B2's last block: dlr[l] = -(sum of leaf l's chunk partials), lane j of a
// warp adding chunks j, j + 32, ... in order, then 5 shuffle levels. Every
// dependent round trip to L2 lengthens the kernel's tail, so a warp first
// issues the loads of kBatch partials per lane for kLeavesPerWarp of its
// leaves (leaves warp, warp + 8, ... of the pass), then adds; a leaf of more
// than 32 * kBatch chunks adds the rest in a loop, in the same order. A tree
// of more than kWarps * kLeavesPerWarp (64) leaves takes several passes,
// which keeps the registers a thread holds at 8 x 4 partials whatever the
// table's capacity; a leaf's sum is the same chain in any pass, so dlr is
// bit-identical across launches and across the two tables. The zeros past a
// leaf's end add exactly.
template <class Tab>
__device__ __forceinline__ void leaf_sums(const Tab& tab, const float* partial, float* dlr) {
  constexpr int kBatch = 4;
  constexpr int kLeavesPerWarp = 8;
  constexpr int kPass = kLeavesPerWarp * kWarps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int base = 0; base < Tab::kCapacity && base < tab.n_leaves; base += kPass) {
    float v[kLeavesPerWarp][kBatch];
#pragma unroll
    for (int j = 0; j < kLeavesPerWarp; ++j) {
      const int l = base + warp + j * kWarps;
      const int first = l < tab.n_leaves ? tab.first_chunk[l] : 0;
      const int end = l < tab.n_leaves ? tab.first_chunk[l + 1] : 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = first + lane + 32 * u;
        v[j][u] = c < end ? __ldcg(partial + c) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kLeavesPerWarp; ++j) {
      const int l = base + warp + j * kWarps;
      if (l >= tab.n_leaves) break;
      float s = 0.0f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s += v[j][u];
      const int end = tab.first_chunk[l + 1];
      for (int c = tab.first_chunk[l] + lane + 32 * kBatch; c < end; c += 32) s += __ldcg(partial + c);
      s = warp_sum(s);
      if (lane == 0) dlr[l] = -s;
    }
  }
}

}  // namespace tree
