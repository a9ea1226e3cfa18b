"""Score networks (port of ``fourierdiffusion_tpu/models/score_models.py``).

* ``ScoreTransformer``: channel embed -> learned positional embedding ->
  Gaussian Fourier time embedding -> post-LN encoder stack -> channel
  unembed;
* ``ScoreMLP``: the series flattened to ``L * C`` -> embed -> time
  embedding (no sequence axis) -> residual MLP blocks -> unembed ->
  reshaped back;
* ``ScoreLSTM``: channel embed -> time embedding -> residual LSTM layers
  -> channel unembed (no positional encoder).

Parameters stay fp32 under the reference PyTorch state-dict names;
``dtype`` is the compute dtype, and the score is cast back to the input's
dtype. Each takes ``forward(x, timesteps, generator=None, *, plain=False)``:
in training mode the transformer's and the MLP's dropouts (``dropout_rate``,
default 0.1 as in JAX) draw from ``generator``, the LSTM draws nothing, and
eval mode draws nothing; ``plain`` selects the attention's plain versions
and means nothing to the MLP and LSTM, which reach no kernel.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from fourierdiffusion_tpu_torch.models.blocks import (
    GaussianFourierProjection,
    MLPBlock,
    PositionalEncoding,
    TorchLinear,
)
from fourierdiffusion_tpu_torch.models.lstm import LSTMLayer
from fourierdiffusion_tpu_torch.models.transformer import TransformerEncoder


def _check_inputs(model: nn.Module, x: torch.Tensor, timesteps: torch.Tensor) -> None:
    if tuple(x.shape[1:]) != (model.max_len, model.n_channels):
        raise ValueError(
            f"X has wrong shape, expected (*, {model.max_len}, {model.n_channels}), "
            f"got {tuple(x.shape)}"
        )
    if timesteps.shape[0] != x.shape[0]:
        raise ValueError("timesteps and x disagree on the batch size")


class ScoreTransformer(nn.Module):
    """Flagship defaults: d_model 72, 10 layers, 12 heads, FFN 2048."""

    def __init__(
        self,
        n_channels: int,
        max_len: int,
        d_model: int = 72,
        num_layers: int = 10,
        n_head: int = 12,
        dim_feedforward: int = 2048,
        dropout_rate: float = 0.1,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.n_channels = n_channels
        self.max_len = max_len
        self.d_model = d_model
        self.num_layers = num_layers
        self.n_head = n_head
        self.dim_feedforward = dim_feedforward
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.embedder = TorchLinear(n_channels, d_model)
        self.pos_encoder = PositionalEncoding(d_model, max_len)
        self.time_encoder = GaussianFourierProjection(d_model)
        self.backbone = TransformerEncoder(
            d_model, n_head, num_layers, dim_feedforward, dropout_rate
        )
        self.unembedder = TorchLinear(d_model, n_channels)

    def forward(
        self, x: torch.Tensor, timesteps: torch.Tensor,
        generator: torch.Generator | None = None, *, plain: bool = False,
    ) -> torch.Tensor:
        """Score for ``x`` ``(B, L, C)`` at times ``(B,)``. In training mode
        the dropout draws come from ``generator`` (on ``x``'s device);
        ``plain=True`` runs the attention's plain versions on any device."""
        _check_inputs(self, x, timesteps)
        in_dtype = x.dtype
        h = self.embedder(x.to(self.dtype))
        h = self.pos_encoder(h)
        h = self.time_encoder(h, timesteps, use_time_axis=True)
        h = self.backbone(h, generator, plain=plain)
        return self.unembedder(h).to(in_dtype)


class ScoreMLP(nn.Module):
    """Residual-MLP score network (reference ``mlp.yaml``: d_mlp 1024)."""

    def __init__(
        self,
        n_channels: int,
        max_len: int,
        d_model: int = 72,
        d_mlp: int = 1024,
        num_layers: int = 10,
        dropout_rate: float = 0.1,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.n_channels = n_channels
        self.max_len = max_len
        self.d_model = d_model
        self.num_layers = num_layers
        self.dtype = dtype
        self.embedder = TorchLinear(max_len * n_channels, d_model)
        self.time_encoder = GaussianFourierProjection(d_model)
        self.backbone = nn.ModuleList(
            MLPBlock(d_model, d_mlp, dropout_rate) for _ in range(num_layers)
        )
        self.unembedder = TorchLinear(d_model, max_len * n_channels)

    def forward(
        self, x: torch.Tensor, timesteps: torch.Tensor,
        generator: torch.Generator | None = None, *, plain: bool = False,
    ) -> torch.Tensor:
        _check_inputs(self, x, timesteps)
        in_dtype, b = x.dtype, x.shape[0]
        h = self.embedder(x.to(self.dtype).reshape(b, self.max_len * self.n_channels))
        h = self.time_encoder(h, timesteps, use_time_axis=False)
        for block in self.backbone:
            h = h + block(h, generator)
        h = self.unembedder(h)
        return h.reshape(b, self.max_len, self.n_channels).to(in_dtype)


class ScoreLSTM(nn.Module):
    """Residual-LSTM score network (reference ``lstm.yaml``)."""

    def __init__(
        self,
        n_channels: int,
        max_len: int,
        d_model: int = 72,
        num_layers: int = 10,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.n_channels = n_channels
        self.max_len = max_len
        self.d_model = d_model
        self.num_layers = num_layers
        self.dtype = dtype
        self.embedder = TorchLinear(n_channels, d_model)
        self.time_encoder = GaussianFourierProjection(d_model)
        self.backbone = nn.ModuleList(LSTMLayer(d_model) for _ in range(num_layers))
        self.unembedder = TorchLinear(d_model, n_channels)

    def forward(
        self, x: torch.Tensor, timesteps: torch.Tensor,
        generator: torch.Generator | None = None, *, plain: bool = False,
    ) -> torch.Tensor:
        _check_inputs(self, x, timesteps)
        in_dtype = x.dtype
        h = self.embedder(x.to(self.dtype))
        h = self.time_encoder(h, timesteps, use_time_axis=True)
        for layer in self.backbone:
            h = h + layer(h)
        return self.unembedder(h).to(in_dtype)


ScoreNetwork = ScoreTransformer | ScoreMLP | ScoreLSTM

MODEL_REGISTRY: dict[str, type[nn.Module]] = {
    "transformer": ScoreTransformer,
    "mlp": ScoreMLP,
    "lstm": ScoreLSTM,
}


@dataclasses.dataclass(frozen=True)
class ScoreModelConfig:
    """Architecture description of any of the three networks."""

    model_type: str = "transformer"  # transformer | mlp | lstm
    d_model: int = 72
    num_layers: int = 10
    n_head: int = 12
    dim_feedforward: int = 2048
    d_mlp: int = 1024
    dropout_rate: float = 0.1
    dtype: str = "float32"

    def build(self, n_channels: int, max_len: int, seed: int | None = None) -> ScoreNetwork:
        """The network, its initial weights drawn from ``seed`` where given
        without touching torch's global CPU generator (else from that
        generator, as a plain constructor does)."""
        if self.model_type not in MODEL_REGISTRY:
            raise ValueError(f"Unknown model_type: {self.model_type!r}")
        common = dict(n_channels=n_channels, max_len=max_len, d_model=self.d_model,
                      num_layers=self.num_layers, dtype=getattr(torch, self.dtype))
        if self.model_type == "transformer":
            kwargs = dict(n_head=self.n_head, dim_feedforward=self.dim_feedforward,
                          dropout_rate=self.dropout_rate)
        elif self.model_type == "mlp":
            kwargs = dict(d_mlp=self.d_mlp, dropout_rate=self.dropout_rate)
        else:
            kwargs = {}
        with torch.random.fork_rng(devices=[], enabled=seed is not None):
            if seed is not None:
                torch.default_generator.manual_seed(seed)
            return MODEL_REGISTRY[self.model_type](**common, **kwargs)


__all__ = [
    "MODEL_REGISTRY",
    "ScoreLSTM",
    "ScoreMLP",
    "ScoreModelConfig",
    "ScoreNetwork",
    "ScoreTransformer",
]
