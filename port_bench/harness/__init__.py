"""The benchmark's general machinery: discovery of cells, configurations
and metrics by name, the closed loop, the trace reader, the correctness
comparison and the result line."""
