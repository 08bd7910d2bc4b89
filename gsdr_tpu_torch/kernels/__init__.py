"""Kernels written by hand for Hopper, each beside its plain version.

``fm_chain.fm_chain`` replaces
gsdr_tpu/kernels/fm_chain_pallas.py::_fm_chain_kernel (dense front).
Sources live in ``csrc/`` and are built with nvcc on first use
(``_build``).
"""
