// Print, for the split-K decode body's instances at D 128 (the paged
// ones at 2 and 16 rows over bf16 and int8 pools, the dense ones at 2
// rows over bf16 and int8 caches) and the wide tensor-core body's at MLA's
// D 576 (bf16 and int8, dense and paged), the CTAs a SM holds, the
// clusters of 1, 2, 4 and 8 CTAs the card holds at once, and the split
// the launcher picks at the main paths' shapes: serve's 16 slots x 8 kv
// heads over a 2048-position table (paged), generate's 8 slots x 8 kv
// heads over a 2048-position cache (dense); at 576 serve's 16 slots and
// generate's 8 of one latent row group (16 heads), and 8 slots of 8 row
// groups (128 heads).
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

// One instance: its registers, CTAs a SM, clusters of 1, 2, 4 and 8 CTAs
// the card holds at once, and the split `pick_split` takes for `pairs`
// clusters of a 2048-position capacity.
template <typename K>
int report(const char* name, K kernel, size_t smem, int threads, int pairs) {
  using shellac::split::kSplits;
  cudaError_t err = shellac::allow_smem(kernel, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  cudaFuncAttributes fa = {};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  int clusters[kSplits] = {};
  for (int i = 0; i < kSplits && err == cudaSuccess; ++i) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1 << i);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
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
         name, fa.numRegs, smem, per_sm, clusters[0], clusters[1],
         clusters[2], clusters[3], pairs,
         shellac::split::pick_split(pairs, 1, kCapacity, clusters));
  return 0;
}

template <typename KT, int R, typename Tiles>
int probe(const char* name, int slots) {
  using namespace shellac::split;
  return report(name, decode_split_kernel<KT, 128, R, Tiles>,
                Layout<KT, 128, R>::kBytes, kThreads, slots * kHkv);
}

template <typename KT, typename Tiles>
int probe_wide(const char* name, int slots, int groups) {
  using namespace shellac::wide;
  return report(name, decode_wide_mma<KT, Tiles>, MmaLayout<KT>::kBytes,
                kThreads, slots * groups);
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
         probe<int8_t, 2, DenseTiles>("dense int8, 2 rows", 8) |
         probe_wide<__nv_bfloat16, PagedTiles>("wide paged bf16, 16 slots",
                                               16, 1) |
         probe_wide<int8_t, PagedTiles>("wide paged int8, 16 slots", 16, 1) |
         probe_wide<__nv_bfloat16, DenseTiles>("wide dense bf16, 8 slots", 8,
                                               1) |
         probe_wide<int8_t, DenseTiles>("wide dense int8, 8 slots", 8, 1) |
         probe_wide<__nv_bfloat16, DenseTiles>(
             "wide dense bf16, 8 slots x 128 heads", 8, 8);
}
