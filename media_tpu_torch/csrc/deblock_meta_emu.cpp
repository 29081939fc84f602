// The C ABI of csrc/deblock_meta.cu built for the host, for the CPU tests
// (tests/test_torch_deblock_meta.py builds it with g++ and hands it to the
// wrapper in place of the kernel library): the entry point runs the same
// per-MB function (deblock_meta.cuh's mb_meta) the kernel runs, over the MBs
// in order, as one thread of a block of one. Pointers are to host memory;
// the stream is not used. Returns 0, or -1 on a bad argument.

#include <stdint.h>

#include "deblock_meta.cuh"

using namespace media_dmeta;

extern "C" int deblock_meta_launch(const int16_t* symbols, const int32_t* qp,
                                   int qp_value, const int32_t* qp_c,
                                   int qp_c_value, const int32_t* qp_map,
                                   const uint8_t* slice_start,
                                   const int32_t* tab, int32_t* meta, int R,
                                   int C, int intra, void*) {
  if (R <= 0 || C <= 0 || (!intra && !symbols)) return -1;
  Args a{};
  a.symbols = symbols;
  a.qp = qp, a.qp_value = qp_value, a.qp_c = qp_c, a.qp_c_value = qp_c_value;
  a.qp_map = qp_map, a.slice_start = slice_start, a.tab = tab, a.meta = meta;
  a.R = R, a.C = C, a.intra = intra;
  Smem s{};
  for (int mb = 0; mb < R * C; ++mb) mb_meta(a, mb, s, 0, 1);
  return 0;
}
