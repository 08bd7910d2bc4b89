"""End-to-end pipelines of the port (counterparts of gsdr_tpu.pipelines)."""

from gsdr_tpu_torch.pipelines.am_radio import AmReceiver
from gsdr_tpu_torch.pipelines.fm_radio import FmChannelizer, fm_deemphasis_coeffs
from gsdr_tpu_torch.pipelines.qpsk_modem import Qpsk256Modem, QpskModem

__all__ = ["AmReceiver", "FmChannelizer", "fm_deemphasis_coeffs",
           "QpskModem", "Qpsk256Modem"]
