from fourierdiffusion_tpu_torch.data.batch import DiffusableBatch
from fourierdiffusion_tpu_torch.data.datamodules import (
    Datamodule,
    DiffusionArrays,
    DummyDatamodule,
    SyntheticDatamodule,
    make_diffusion_arrays,
)

__all__ = [
    "Datamodule",
    "DiffusableBatch",
    "DiffusionArrays",
    "DummyDatamodule",
    "SyntheticDatamodule",
    "make_diffusion_arrays",
]
