// The flash backward (dQ and dK/dV kernels) of flash_attention_bwd_sm90.cuh
// at head-width classes 16, 32 and 48 (head_dim 1..48; the Conformer's 36
// rides in 48).
#include "flash_attention_bwd_sm90.cuh"

#define CLASSES(X) X(16) X(32) X(48)
PTT_FLASH_SM90_BWD(CLASSES)
