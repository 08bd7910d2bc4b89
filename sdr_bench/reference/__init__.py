"""Plain receivers in float64 PyTorch and NumPy, the yardstick of
``correct``. They import neither JAX nor any part of gsdr_tpu or
gsdr_tpu_torch, and take nothing the program made: only the capture and
the design (taps, channel list, parameters) that both sides are given."""
