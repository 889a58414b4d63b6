// Print, for the split-K decode body's instances at D 128 (the paged
// ones at 2 and 16 rows over bf16 and int8 pools, the dense ones at 2
// rows over bf16 and int8 caches), the CTAs a SM holds, the clusters of
// 1, 2, 4 and 8 CTAs the card holds at once, and the split the launcher
// picks at the main paths' shapes: serve's 16 slots x 8 kv heads over a
// 2048-position table (paged), generate's 8 slots x 8 kv heads over a
// 2048-position cache (dense).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/split_occupancy scripts/split_occupancy.cu
//   build/split_occupancy
//
// Needs a Hopper card; prints one JSON line an instance.
#include <cstdio>

#include "../shellac_tpu_torch/csrc/decode_attention.cu"
#include "../shellac_tpu_torch/csrc/paged_decode_attention.cu"

namespace {

constexpr int kHkv = 8, kCapacity = 2048;

template <typename KT, int R, typename Tiles>
int probe(const char* name, int slots) {
  using namespace shellac::split;
  auto kernel = decode_split_kernel<KT, 128, R, Tiles>;
  constexpr size_t kSmem = Layout<KT, 128, R>::kBytes;
  cudaError_t err = shellac::allow_smem(kernel, kSmem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, kSmem);
  cudaFuncAttributes fa = {};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  int clusters[kSplits] = {};
  for (int i = 0; i < kSplits && err == cudaSuccess; ++i) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1 << i);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1 << i;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&clusters[i], kernel, &cfg);
  }
  if (err != cudaSuccess) {
    printf("{\"instance\": \"%s\", \"error\": \"%s\"}\n", name,
           cudaGetErrorString(err));
    return 1;
  }
  printf("{\"instance\": \"%s\", \"registers\": %d, \"smem_bytes\": %zu, "
         "\"ctas_per_sm\": %d, \"clusters_of_1_2_4_8\": [%d, %d, %d, %d], "
         "\"pairs\": %d, \"split\": %d}\n",
         name, fa.numRegs, kSmem, per_sm, clusters[0], clusters[1],
         clusters[2], clusters[3], slots * kHkv,
         pick_split(slots, kHkv, kCapacity, clusters));
  return 0;
}

}  // namespace

int main() {
  using shellac::DenseTiles;
  using shellac::PagedTiles;
  return probe<__nv_bfloat16, 2, PagedTiles>("paged bf16, 2 rows", 16) |
         probe<__nv_bfloat16, 16, PagedTiles>("paged bf16, 16 rows", 16) |
         probe<int8_t, 2, PagedTiles>("paged int8, 2 rows", 16) |
         probe<int8_t, 16, PagedTiles>("paged int8, 16 rows", 16) |
         probe<__nv_bfloat16, 2, DenseTiles>("dense bf16, 2 rows", 8) |
         probe<int8_t, 2, DenseTiles>("dense int8, 2 rows", 8);
}
