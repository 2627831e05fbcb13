// The flash forward of flash_attention_sm90.cuh at head-width classes 96,
// 160, 192, 224 and 256 (head_dim 65..96 and 129..256).
#include "flash_attention_sm90.cuh"

#define CLASSES(X) X(96) X(160) X(192) X(224) X(256)
PTT_FLASH_SM90_FWD(CLASSES)
