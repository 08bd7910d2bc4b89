"""Kernels written by hand for Hopper, each beside its plain version.

``fm_chain.fm_chain`` and ``fm_chain.pfb_fm_chain`` replace
gsdr_tpu/kernels/fm_chain_pallas.py::_fm_chain_kernel with its dense and
its PFB front; ``am_chain.am_chain`` and ``am_chain.pfb_am_chain`` replace
``_am_chain_kernel`` with the same two fronts. ``chain`` holds what they
share: the launch-counting wrapper, the checks made before a launch and
the receivers' choice of front. Sources live in ``csrc/`` (the fronts,
shared, in ``fronts.cuh``) and are built with nvcc on first use
(``_build``).
"""
