"""Epoch 1's training loss against epoch 0's validation loss (ROADMAP C3), on
the CPU, in the port and in the JAX package.

chip_smoke.py's phase 18 (b) trains the flagship transformer 2 epochs on
MIT-BIH files written by ``data/raw_formats.py`` and read epoch 1's training
loss equal to epoch 0's validation loss to 1.3e-5 relative. This script
runs that configuration (d_model 72, 10 layers, 12 heads, FFN 2048, batch
64, lr 1e-3, EMA off, seed 42, the DFT and standardisation; 512 and 128
rows from seed 0) through the port's ``Trainer`` or the JAX package's
(its flax module on the CPU), from the initial weights of ``--init-seed``
(the CLIs draw them from ``random_seed``, 42; the two packages draw other
weights from one seed), and prints both losses and their relative
difference. Run it from the repository root, once per package::

    PYTHONPATH=. python scripts/c3_epoch_losses.py port [--init-seed 42]
    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/c3_epoch_losses.py jax [--init-seed 42]

Each takes a few minutes on 4 CPU threads. ``--device cuda`` runs the port
on the card instead, through its kernels and the CUDA generator's draws
(which differ from the CPU generator's).
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from fourierdiffusion_tpu_torch.data import raw_formats


def main(which: str, init_seed: int, device: str) -> None:
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        raw_formats.write_mitbih(root, np.random.default_rng(0), 512, 128)
        kw = dict(data_dir=root, random_seed=42, fourier_transform=True, standardize=True,
                  batch_size=64)
        t0 = time.time()
        if which == "port":
            from fourierdiffusion_tpu_torch.data.datamodules import DATAMODULE_REGISTRY
            from fourierdiffusion_tpu_torch.models import ScoreModelConfig
            from fourierdiffusion_tpu_torch.schedulers import VPScheduler
            from fourierdiffusion_tpu_torch.training import Trainer

            dm = DATAMODULE_REGISTRY["ecg"](**kw)
            dm.prepare_data()
            dm.setup()
            model = ScoreModelConfig().build(1, 187, seed=init_seed)
            history = Trainer(model, VPScheduler(fourier_noise_scaling=True), max_epochs=2,
                              device=device).fit(dm)
        else:
            from fourierdiffusion_tpu.data.datamodules import DATAMODULE_REGISTRY
            from fourierdiffusion_tpu.models import ScoreModelConfig
            from fourierdiffusion_tpu.schedulers import VPScheduler
            from fourierdiffusion_tpu.training.trainer import Trainer

            dm = DATAMODULE_REGISTRY["ecg"](**kw)
            dm.prepare_data()
            dm.setup()
            model = ScoreModelConfig(model_type="transformer").build(n_channels=1, max_len=187)
            trainer = Trainer(model, VPScheduler(fourier_noise_scaling=True), max_epochs=2,
                              init_seed=init_seed)
            trainer.fit(dm)
            history = trainer.history
    (train0, val0), (train1, val1) = [(h["train/loss"], h["val/loss"]) for h in history]
    print(f"{which} on {device}, init seed {init_seed}: epoch 0 train {train0!r} val "
          f"{val0!r}; epoch 1 train {train1!r} val {val1!r}; |train1 - val0| / val0 = "
          f"{abs(train1 - val0) / abs(val0):.3e}; {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("which", choices=("port", "jax"))
    parser.add_argument("--init-seed", type=int, default=42)
    parser.add_argument("--device", default="cpu", help="the port's device: cpu or cuda")
    args = parser.parse_args()
    main(args.which, args.init_seed, args.device)
