"""ROADMAP C3, reproduced on the CPU: the port's trainer for 2 epochs from
seed 42 on MIT-BIH files written by ``data/raw_formats.py`` (512 and 128
rows), with a small transformer and the MLP. On the card, chip_smoke.py's
2-epoch ECG and MLP runs read epoch 1's training loss equal to epoch 0's
validation loss to 1.3e-5 and 3.4e-6 relative. On the CPU the two differ
by more than 1e-3 relative (the training loss is taken in training mode,
with dropout and other noise draws, on the weights of a moving epoch; the
validation loss on fixed draws, in eval mode). ``scripts/c3_epoch_losses.py``
runs the same comparison at the flagship's width in the port and in the JAX
package (their readings are in ROADMAP.md, queue C).
"""

from __future__ import annotations

import numpy as np
import pytest

from fourierdiffusion_tpu_torch.data import raw_formats
from fourierdiffusion_tpu_torch.data.datamodules import DATAMODULE_REGISTRY
from fourierdiffusion_tpu_torch.models import ScoreModelConfig
from fourierdiffusion_tpu_torch.schedulers import VPScheduler
from fourierdiffusion_tpu_torch.training import Trainer

ARCH = dict(d_model=16, num_layers=1, n_head=2, dim_feedforward=32, d_mlp=32)
MIN_GAP = 1e-3


@pytest.mark.parametrize("model_type", ["transformer", "mlp"])
def test_epoch_losses_do_not_coincide_on_ecg_files(tmp_path, model_type: str) -> None:
    raw_formats.write_mitbih(tmp_path, np.random.default_rng(0), 512, 128)
    dm = DATAMODULE_REGISTRY["ecg"](data_dir=tmp_path, random_seed=42, fourier_transform=True,
                                    standardize=True, batch_size=64)
    dm.prepare_data()
    dm.setup()
    model = ScoreModelConfig(model_type=model_type, **ARCH).build(1, 187, seed=0)
    history = Trainer(model, VPScheduler(fourier_noise_scaling=True), max_epochs=2,
                      device="cpu").fit(dm)
    val0, train1 = history[0]["val/loss"], history[1]["train/loss"]
    assert np.isfinite([val0, train1]).all()
    assert abs(train1 - val0) / abs(val0) > MIN_GAP, (train1, val0)
