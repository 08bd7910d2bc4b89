"""Port parity: the QPSK and QPSK256 modems, built from the JAX modems'
fields through gsdr_tpu_torch.utils.convert (JAX on CPU)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.ops.qpsk256 import CIRCULAR, RECTANGULAR
from gsdr_tpu.pipelines import Qpsk256Modem as JQ256
from gsdr_tpu.pipelines import QpskModem as JQ
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.ops import qpsk256 as tq256
from gsdr_tpu_torch.pipelines import Qpsk256Modem, QpskModem
from gsdr_tpu_torch.utils.convert import (
    qpsk256_modem_from_fields,
    qpsk_modem_from_fields,
)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _awgn(sigma, seed):
    rng = np.random.default_rng(seed)

    def channel_np(n):
        return (sigma * rng.standard_normal(n).astype(np.float32),
                sigma * rng.standard_normal(n).astype(np.float32))
    return channel_np


@pytest.mark.parametrize("amp", [1.0, 0.5])
def test_qpsk_modem_matches_jax(amp):
    """tx bit-equal (sign arithmetic), rx of the same noisy samples
    bit-equal, loopback exact; the port's bytes are uint8."""
    jm = JQ(amplitude=amp)
    tm = qpsk_modem_from_fields(dataclasses.asdict(jm), device="cpu")
    assert tm == QpskModem(amplitude=amp, device="cpu")
    b = np.random.default_rng(1).integers(0, 256, (3, 64)).astype(np.uint8)
    ts, js = tm.tx(b), jm.tx(b)
    _eq(ts.re.numpy(), js.re)
    _eq(ts.im.numpy(), js.im)
    _eq(tm.tx(b, num_symbols=10).re.numpy(), jm.tx(b, num_symbols=10).re)
    nre, nim = _awgn(0.3 * amp, 2)(ts.re.numel())
    nre, nim = nre.reshape(3, -1), nim.reshape(3, -1)
    jrx = jm.rx(JCA(js.re + nre, js.im + nim))
    trx = tm.rx(TCA(ts.re + torch.from_numpy(nre), ts.im + torch.from_numpy(nim)))
    assert trx.dtype == torch.uint8
    _eq(trx.numpy(), jrx)
    _eq(tm.loopback(b).numpy(), b)
    _eq(tm.rx(ts, out_dtype=torch.int32).numpy(), jm.rx(js))


@pytest.mark.parametrize("ctype", [RECTANGULAR, CIRCULAR])
@pytest.mark.parametrize("exact", [False, True])
def test_qpsk256_modem_matches_jax(ctype, exact):
    """tx within 1e-6 (bit-equal on the table and rectangular paths), rx
    of the same noisy samples bit-equal, loopback exact."""
    jm = JQ256(constellation_type=ctype, amplitude=1.3, exact_tables=exact)
    tm = qpsk256_modem_from_fields(dataclasses.asdict(jm), device="cpu")
    assert (tm.constellation_type, tm.amplitude, tm.exact_tables) == \
        (ctype, 1.3, exact)
    s = np.random.default_rng(3).integers(0, 256, (2, 2000)).astype(np.uint8)
    ts, js = tm.tx(s), jm.tx(s)
    np.testing.assert_allclose(ts.re.numpy(), np.asarray(js.re), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ts.im.numpy(), np.asarray(js.im), rtol=0,
                               atol=1e-6)
    if exact or ctype == RECTANGULAR:
        _eq(ts.re.numpy(), js.re)
    nre, nim = _awgn(0.02, 4)(s.size)
    nre, nim = nre.reshape(s.shape), nim.reshape(s.shape)
    rx_t = tm.rx(TCA(torch.from_numpy(np.asarray(js.re) + nre),
                     torch.from_numpy(np.asarray(js.im) + nim)))
    rx_j = jm.rx(JCA(js.re + nre, js.im + nim))
    assert rx_t.dtype == torch.uint8
    _eq(rx_t.numpy(), rx_j)
    _eq(tm.loopback(s).numpy(), s)
    _eq(tm.constellation().re.numpy(), jm.constellation().re)


@pytest.mark.parametrize("ctype", [RECTANGULAR, CIRCULAR])
def test_exact_tables_routing(ctype, monkeypatch):
    """exact_tables=True sends tx to the table lookup and rx to the
    exhaustive demodulator (the QPSK256 kernel's route on the card);
    False to the geometry's arithmetic paths."""
    calls = []

    def spy(name):
        fn = getattr(tq256, name)

        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    from gsdr_tpu_torch.pipelines import qpsk_modem as tmod

    for name in ("qpsk256_modulate", "qpsk256_modulate_rect",
                 "qpsk256_modulate_circular", "qpsk256_demodulate",
                 "qpsk256_demodulate_rect", "qpsk256_demodulate_circular"):
        monkeypatch.setattr(tmod, name, spy(name))
    geo = "rect" if ctype == RECTANGULAR else "circular"
    for exact, want in ((True, ["qpsk256_modulate", "qpsk256_demodulate"]),
                        (False, [f"qpsk256_modulate_{geo}",
                                 f"qpsk256_demodulate_{geo}"])):
        calls.clear()
        Qpsk256Modem(ctype, 1.0, exact, device="cpu").loopback(
            np.arange(256, dtype=np.uint8))
        assert calls == want


def test_modems_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (QpskModem, Qpsk256Modem):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        qpsk256_modem_from_fields({"constellation_type": CIRCULAR,
                                   "amplitude": 1.0, "exact_tables": True})
