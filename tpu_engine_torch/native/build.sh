#!/usr/bin/env bash
# Builds libtpucore_torch.so, the port's native core (no CUDA):
#   tpu_engine_torch/native/build.sh OUT_PATH
# tpu_engine_torch/core/native.py runs it at first use. $CXX names the
# compiler (default g++). Only the extern "C" API is exported.
set -euo pipefail
cd "$(dirname "$0")"
out="${1:?usage: build.sh OUT_PATH}"
"${CXX:-g++}" -std=c++17 -O3 -Wall -Wextra -fPIC -shared -pthread \
  -fvisibility=hidden core_api.cc -o "$out"
