#!/bin/sh
# Build the native scenario generator into the package directory.
set -e
cd "$(dirname "$0")"
g++ -O2 -shared -fPIC -std=c++17 -o ../apf_quadruped/runtime/libscenariogen.so scenario_gen.cpp
echo "built apf_quadruped/runtime/libscenariogen.so"
