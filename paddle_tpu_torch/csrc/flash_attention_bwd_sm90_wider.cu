// The flash backward (dQ and dK/dV kernels) of flash_attention_bwd_sm90.cuh
// at head-width classes 192, 224 and 256 (head_dim 161..256).
#include "flash_attention_bwd_sm90.cuh"

#define CLASSES(X) X(192) X(224) X(256)
PTT_FLASH_SM90_BWD(CLASSES)
