"""Kernels written by hand for Hopper, each beside its plain version.

``fm_chain.fm_chain`` and ``fm_chain.pfb_fm_chain`` replace
gsdr_tpu/kernels/fm_chain_pallas.py::_fm_chain_kernel with its dense and
its PFB front; ``am_chain.am_chain`` and ``am_chain.pfb_am_chain`` replace
``_am_chain_kernel`` with the same two fronts;
``channelize.channelize_kernel`` replaces
gsdr_tpu/kernels/channelize_pallas.py::_channelize_kernel with the dense
front alone; ``qpsk256.qpsk256_kernel`` replaces
gsdr_tpu/kernels/qpsk256_pallas.py::_demod_kernel; ``iir.iir_kernel``
replaces gsdr_tpu/kernels/iir_pallas.py::_iir_kernel. The dense front runs
at the JAX package's grades: 'bf16x3' (the default) and 'bf16x2' on the
tensor cores, 'f32' on the FP32 FMAs. ``chain`` holds what the wrappers
share: the launch-counting wrapper, the checks made before a launch, the
grades' host side (the bf16 split, the tensor-core tap table, the plain
front at each grade) and the receivers' choice of front. Sources live in
``csrc/`` (the
fronts, shared, in ``fronts.cuh``) and are built with nvcc on first use
(``_build``). ``kmath`` holds the JAX package's polynomial atan, sincos and
atan2 as plain tensor functions.
"""
