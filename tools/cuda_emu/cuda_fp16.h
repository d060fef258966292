// cuda_fp16.h for the emulator: its types and conversions live in
// cuda_runtime.h
#pragma once
#include "cuda_runtime.h"
