"""Oscillator signal generators (counterpart of ``gsdr_tpu/ops/trig.py``).

N samples along a linear phase ramp from phi_begin with the per-sample
increment (phi_end - phi_begin) / N, the end point excluded. The increment
is computed in float64 on the host and rounded to float32 once, as the JAX
package does; the ramp itself is float32 on the device.
"""

import numpy as np
import torch

from gsdr_tpu_torch.carray import expj


def _phase_ramp(phi_begin, phi_end, num_elements, device):
    step = float(np.float32((float(phi_end) - float(phi_begin))
                            / float(num_elements)))
    i = torch.arange(num_elements, dtype=torch.float32, device=device)
    return float(np.float32(phi_begin)) + i * step


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available; pass device='cpu'")
    return device


def cosine_c(phi_begin, phi_end, num_elements, planar=False, device="cuda"):
    """Complex exponential e^{j*theta_i} = cos(theta_i) + j*sin(theta_i):
    complex64, or a planar ComplexArray with ``planar=True``."""
    lo = expj(_phase_ramp(phi_begin, phi_end, num_elements, _device(device)))
    return lo if planar else lo.to_complex()


def cosine_f(phi_begin, phi_end, num_elements, device="cuda"):
    """Real cosine along the phase ramp, float32."""
    return torch.cos(_phase_ramp(phi_begin, phi_end, num_elements,
                                 _device(device)))
