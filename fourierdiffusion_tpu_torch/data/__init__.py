from fourierdiffusion_tpu_torch.data.batch import DiffusableBatch
from fourierdiffusion_tpu_torch.data.datamodules import (
    DATAMODULE_REGISTRY,
    Datamodule,
    DiffusionArrays,
    DummyDatamodule,
    ECGDatamodule,
    MIMICIIIDatamodule,
    NASADatamodule,
    NASDAQDatamodule,
    SyntheticDatamodule,
    USDroughtsDatamodule,
    make_diffusion_arrays,
)

__all__ = [
    "DATAMODULE_REGISTRY",
    "Datamodule",
    "DiffusableBatch",
    "DiffusionArrays",
    "DummyDatamodule",
    "ECGDatamodule",
    "MIMICIIIDatamodule",
    "NASADatamodule",
    "NASDAQDatamodule",
    "SyntheticDatamodule",
    "USDroughtsDatamodule",
    "make_diffusion_arrays",
]
