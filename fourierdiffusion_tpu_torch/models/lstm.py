"""Unidirectional LSTM layer of ``ScoreLSTM`` (port of
``fourierdiffusion_tpu/models/lstm.py``).

``nn.LSTM(d, d, batch_first=True)``, the reference's own module, so its
parameters load under the reference's names (``weight_ih_l0``,
``weight_hh_l0``, ``bias_ih_l0``, ``bias_hh_l0``; gate order i, f, g, o)
and it runs on cuDNN on the card. ``nn.LSTM``'s default init is JAX's
``lstm_uniform_init``: every parameter U(-1/sqrt(h), 1/sqrt(h)). The
parameters stay fp32; an input of another dtype (bf16) runs the layer in
that dtype with the weights cast to it, as the JAX layer does. The JAX
package runs no Pallas kernel here: its layer is a ``lax.scan``.
"""

from __future__ import annotations

import torch
from torch import nn


class LSTMLayer(nn.LSTM):
    """One LSTM layer ``(B, L, D) -> (B, L, D)``, zero initial state."""

    def __init__(self, hidden_size: int) -> None:
        super().__init__(hidden_size, hidden_size, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        if x.dtype == self.weight_ih_l0.dtype:
            return super().forward(x)[0]
        weights = [w.to(x.dtype) for w in self._flat_weights]
        h0 = x.new_zeros(1, x.shape[0], self.hidden_size)
        out, _, _ = torch.lstm(x, (h0, h0), weights, True, 1, 0.0, self.training, False, True)
        return out


__all__ = ["LSTMLayer"]
