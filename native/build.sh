#!/bin/sh
# Build the native host-runtime library into native/build/ (git-ignored).
# The library is compiled under a temporary name and renamed into place, so
# concurrent builds never expose a partly written file.
set -e
cd "$(dirname "$0")"
mkdir -p build
tmp="build/liboipnative.so.$$"
g++ -O3 -march=native -fPIC -shared -std=c++17 -D_GNU_SOURCE \
    oipnative.cpp -o "$tmp"
mv -f "$tmp" build/liboipnative.so
echo "built $(pwd)/build/liboipnative.so"
