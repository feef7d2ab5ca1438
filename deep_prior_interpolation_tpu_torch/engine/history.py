"""Host-side optimisation histories (counterpart of ``engine/history.py``),
filled from the device once per chunk."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..utils.generic import ten_digit


class History:
    """loss / snr / pcorr / lr traces."""

    FIELDS = ("loss", "snr", "pcorr", "lr")
    MSG = "Iter %s, Loss = %+.2e, SNR = %+2.2f dB, PCORR = %+.2f %%"

    def __init__(self, epochs: int):
        self.epochs = epochs
        self.zfill = ten_digit(epochs)
        for f in self.FIELDS:
            setattr(self, f, [])

    def extend(self, chunk: Dict[str, np.ndarray], n: int) -> None:
        """Append the first ``n`` entries of each per-chunk buffer."""
        for f in self.FIELDS:
            getattr(self, f).extend(np.asarray(chunk[f][:n]).tolist())

    def append(self, values) -> None:
        for f, v in zip(self.FIELDS[:len(values)], values):
            getattr(self, f).append(float(v))

    def __len__(self) -> int:
        return len(self.loss)

    def __getitem__(self, item):
        return tuple(getattr(self, f)[item] for f in self.FIELDS if f != "lr")

    def log_message(self, idx: int) -> str:
        return self.MSG % (str(idx + 1).zfill(self.zfill), self.loss[idx],
                           self.snr[idx], self.pcorr[idx] * 100)

    def as_dict(self) -> Dict[str, List[float]]:
        return {f: list(getattr(self, f)) for f in self.FIELDS}


class HistoryReg(History):
    """+ data-fit and regulariser traces."""

    FIELDS = ("loss", "df", "reg", "snr", "pcorr", "lr")
    MSG = "Iter %s, Loss = %+.2e, DF = %.2e, REG = %.2e, SNR = %+.2f dB, PCORR = %+.2f %%"

    def log_message(self, idx: int) -> str:
        return self.MSG % (str(idx + 1).zfill(self.zfill), self.loss[idx],
                           self.df[idx], self.reg[idx], self.snr[idx],
                           self.pcorr[idx] * 100)


class HistoryPOCS(HistoryReg):
    """+ adaptive-eps and threshold traces."""

    FIELDS = ("loss", "df", "reg", "eps", "snr", "pcorr", "th", "lr")
    MSG = ("Iter %s, loss=%.2e, df=%.2e, reg=%.2e, eps=%.2e, SNR=%+.2fdB, "
           "th=%.2e")

    def log_message(self, idx: int) -> str:
        return self.MSG % (str(idx + 1).zfill(self.zfill), self.loss[idx],
                           self.df[idx], self.reg[idx], self.eps[idx],
                           self.snr[idx], self.th[idx])
