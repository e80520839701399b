"""The port's native host library: the async .npy writer's C++ backend
(`build.py` compiles `ns_tpu_torch/csrc/stream_writer.cpp` with g++ at
first use)."""
