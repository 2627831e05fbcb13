// The flash backward (dQ and dK/dV kernels) of flash_attention_bwd_sm90.cuh
// at head-width classes 96 and 160 (head_dim 65..96 and 129..160).
#include "flash_attention_bwd_sm90.cuh"

#define CLASSES(X) X(96) X(160)
PTT_FLASH_SM90_BWD(CLASSES)
