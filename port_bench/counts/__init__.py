"""Operations and bytes that a kernel's or a step's function needs,
computed from its shapes, and the chip's peaks (peaks.py). A roofline
share divides the least time these allow by the measured time."""
