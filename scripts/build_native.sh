#!/bin/bash
# Build the native runtime components (C++ -> shared lib, ctypes-consumed).
set -e
cd "$(dirname "$0")/.."
g++ -O3 -shared -fPIC -std=c++17 -o srslte_emane_tpu/native/libemanelte.so \
    srslte_emane_tpu/native/emanelte_bus.cpp
g++ -O3 -std=c++17 -o srslte_emane_tpu/native/ota_hub \
    srslte_emane_tpu/native/ota_hub.cpp
echo "built srslte_emane_tpu/native/libemanelte.so + ota_hub"
