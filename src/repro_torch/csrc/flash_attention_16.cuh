// The 16-bit prefill attention kernel's launch (flash_attention_16.cu),
// called by the C entry point sfp_flash_attention_fwd in
// flash_attention.cu for bf16 and f16 q, k and v.
#pragma once

#include <cuda_runtime.h>

namespace sfp {

// q, k, v and o of one 16-bit dtype; strides in elements
struct Prefill16Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, Hq, Hkv, Dh, Dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float softcap, scale;
  int kv_len;
  int rows;  // query rows a block: 16, 32 or 64 (prefill_plan's choice)
};

// Launch the 16-bit kernel for dtype kBF16 or kF16; `vec`: every base and
// stride of q, k and v is a multiple of 8 values (16-byte cp.async).
cudaError_t flash16_fwd(const Prefill16Params& p, int dtype, bool vec,
                        cudaStream_t stream);

}  // namespace sfp
