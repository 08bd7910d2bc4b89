"""Example: QPSK and QPSK256 links over AWGN, with BER and SER.

Counterpart of ``examples/qpsk_link.py``: the QPSK modem at 4, 7 and 10 dB
SNR, and the 256-ary modem of each geometry at 20 and 26 dB, on the card
(``--cpu`` for the CPU). The noise is drawn with numpy from one seed, as
the JAX example draws it. The link passes when the QPSK BER at 10 dB stays
under 1e-2 (theory: 7.7e-4) and each 256-ary SER falls from 20 to 26 dB.

Run from the repository root:

    python -m gsdr_tpu_torch.examples.qpsk_link [--cpu]
"""

import argparse

import numpy as np
import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.ops.qpsk256 import CIRCULAR, RECTANGULAR
from gsdr_tpu_torch.pipelines import Qpsk256Modem, QpskModem


def awgn(sig, snr_db, es, rng):
    """sig plus complex white noise at ``snr_db`` below the symbol energy
    ``es``, drawn from the numpy generator ``rng``."""
    sigma = np.sqrt(es / (2.0 * 10 ** (snr_db / 10.0)))

    def noise():
        n = rng.standard_normal(tuple(sig.shape)).astype(np.float32)
        return torch.from_numpy(n).to(sig.device) * sigma

    return ComplexArray(sig.re + noise(), sig.im + noise())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    rng = np.random.default_rng(0)
    nbytes = 1 << 15
    ok = True

    modem = QpskModem(device=device)
    data = rng.integers(0, 256, nbytes).astype(np.uint8)
    tx = modem.tx(torch.from_numpy(data))
    for snr in (4.0, 7.0, 10.0):
        rx = modem.rx(awgn(tx, snr, es=2.0, rng=rng)).cpu().numpy()
        ber = np.mean(np.unpackbits(data[:, None], axis=1)
                      != np.unpackbits(rx.astype(np.uint8)[:, None], axis=1))
        print(f"QPSK   {snr:4.1f} dB SNR: BER = {ber:.2e}")
    ok &= ber < 1e-2

    for ctype, name in ((RECTANGULAR, "rect"), (CIRCULAR, "circ")):
        m256 = Qpsk256Modem(ctype, device=device)
        syms = rng.integers(0, 256, nbytes).astype(np.uint8)
        tx = m256.tx(torch.from_numpy(syms))
        es = float(torch.mean(tx.re ** 2 + tx.im ** 2))
        sers = []
        for snr in (20.0, 26.0):
            rx = m256.rx(awgn(tx, snr, es=es, rng=rng)).cpu().numpy()
            sers.append(float(np.mean(rx != syms)))
            print(f"QPSK256/{name} {snr:4.1f} dB SNR: SER = {sers[-1]:.2e}")
        ok &= sers[1] < sers[0]
    print("links ok" if ok else "LINK FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
